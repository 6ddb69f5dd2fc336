"""Sound layer: the batched software mixer (fyrox-sound), Sound and
Listener node glue, the bus graph with its effects, and the binaural
path."""
from fyrox_tpu_torch.sound import binaural, bus, engine, scene
from fyrox_tpu_torch.sound.engine import (SAMPLE_RATE, DistanceModel,
                                          SoundBuffers, SourceState,
                                          init_sources, load_wav,
                                          render_block)

__all__ = ["binaural", "bus", "engine", "scene", "SAMPLE_RATE",
           "DistanceModel", "SoundBuffers", "SourceState", "init_sources",
           "render_block", "load_wav"]
