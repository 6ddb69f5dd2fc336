"""Audio bus graph and effects, the port of ``fyrox_tpu/sound/bus.py``
(fyrox-sound bus.rs, effects/).

Every source routes into a bus; buses form a tree whose root (the primary
bus) reaches the output, and each bus runs an effect chain. ``BusGraph``
is the host template (parents, gains, effect chains), ``BusState`` the
filter and delay-line state carried across blocks, and ``process`` folds
the per-bus stereo blocks through their effects and sums them up the tree,
deepest bus first (a child's wet output feeds its parent, bus.rs order).

Effects:
  * biquad filters, low-pass / high-pass / band-pass / all-pass, RBJ
    cookbook coefficients (effects/filter.rs wraps the same family);
  * reverb, a Schroeder unit: 4 parallel feedback combs, then an allpass
    (the topology effects/reverb.rs builds);
  * per-bus gain.

The biquad and the reverb are per-sample recurrences (``lax.scan`` in the
JAX package). Here each is a Python loop over the block's samples on
tensors, in the same order of operations: a dozen small launches a sample
on the card, so a block costs thousands of launches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple

import numpy as np
import torch

from fyrox_tpu_torch._util import const, resolve_device

__all__ = ["BusGraph", "BusState", "biquad_coeffs", "init_state", "process"]

SAMPLE_RATE = 44100.0
_COMB_DELAYS = (1116, 1188, 1277, 1356)      # Freeverb-family primes
_ALLPASS_DELAY = 556
_MAX_DELAY = 1500
_COMB_DELAYS_NP = np.asarray(_COMB_DELAYS, np.int64)


def biquad_coeffs(kind, freq, q=0.7071, sample_rate=SAMPLE_RATE):
    """RBJ cookbook biquad (b0, b1, b2, a1, a2), normalised by a0."""
    w0 = 2.0 * np.pi * freq / sample_rate
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "lowpass":
        b0, b1, b2 = (1 - cw) / 2, 1 - cw, (1 - cw) / 2
    elif kind == "highpass":
        b0, b1, b2 = (1 + cw) / 2, -(1 + cw), (1 + cw) / 2
    elif kind == "bandpass":
        b0, b1, b2 = alpha, 0.0, -alpha
    elif kind == "allpass":
        b0, b1, b2 = 1 - alpha, -2 * cw, 1 + alpha
    else:
        raise ValueError(kind)
    a0, a1, a2 = 1 + alpha, -2 * cw, 1 - alpha
    return np.asarray([b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0],
                      np.float32)


@dataclass
class BusGraph:
    """Host bus-tree template; bus 0 is the primary bus (bus.rs
    PRIMARY_BUS)."""
    parents: np.ndarray                    # [N] int32 (-1 for primary)
    gains: np.ndarray                      # [N] f32
    # per-bus effect chains: ("biquad", coeffs[5]) / ("reverb", wet)
    effects: List[List[tuple]] = field(default_factory=list)

    @staticmethod
    def build(buses):
        """buses: list of dicts(parent=-1, gain=1.0, effects=[...])."""
        return BusGraph(
            parents=np.asarray([b.get("parent", -1) for b in buses],
                               np.int32),
            gains=np.asarray([b.get("gain", 1.0) for b in buses], np.float32),
            effects=[list(b.get("effects", [])) for b in buses])

    @property
    def num_buses(self):
        return int(self.parents.shape[0])

    def depth_order(self):
        """Bus indices deepest first (children before parents)."""
        depth = np.zeros(self.num_buses, np.int64)
        for i in range(self.num_buses):
            d, j = 0, i
            while self.parents[j] >= 0:
                j = int(self.parents[j])
                d += 1
            depth[i] = d
        return list(np.argsort(-depth, kind="stable"))


class BusState(NamedTuple):
    """Carried across blocks: biquad histories and reverb delay lines."""
    bq_x: torch.Tensor     # [N_biquads, 2, 2] (x[n-1], x[n-2]) per channel
    bq_y: torch.Tensor     # [N_biquads, 2, 2]
    rv_comb: torch.Tensor  # [N_reverbs, 4, MAX_DELAY, 2]
    rv_ap: torch.Tensor    # [N_reverbs, MAX_DELAY, 2]
    rv_pos: torch.Tensor   # [N_reverbs] int32 write cursor


def init_state(graph: BusGraph, device="cuda") -> BusState:
    """Silent filter histories and delay lines, on the card unless `device`
    says otherwise."""
    device = resolve_device(device)
    nb = sum(1 for ch in graph.effects for e in ch if e[0] == "biquad")
    nr = sum(1 for ch in graph.effects for e in ch if e[0] == "reverb")

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return BusState(bq_x=z(max(nb, 1), 2, 2), bq_y=z(max(nb, 1), 2, 2),
                    rv_comb=z(max(nr, 1), 4, _MAX_DELAY, 2),
                    rv_ap=z(max(nr, 1), _MAX_DELAY, 2),
                    rv_pos=z(max(nr, 1), dtype=torch.int32))


def _run_biquad(block, coeffs, x_hist, y_hist):
    """The IIR over the block [B,2], one sample at a time; returns (out,
    new x history, new y history)."""
    b0, b1, b2, a1, a2 = const(np.asarray(coeffs, np.float32),
                               block.device).unbind(0)
    x1, x2, y1, y2 = x_hist[0], x_hist[1], y_hist[0], y_hist[1]
    out = []
    for x in block.unbind(0):
        y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x1, x2, y1, y2 = x, x1, y, y1
        out.append(y)
    return torch.stack(out), torch.stack([x1, x2]), torch.stack([y1, y2])


def _run_reverb(block, wet, comb, ap, pos):
    """Schroeder: 4 parallel feedback combs → 1 allpass, one sample at a
    time; mixes `wet` of it in. comb [4,MAX,2] and ap [MAX,2] are updated
    in place (the caller passes copies); pos is a 0-d int32 tensor.
    Returns (out, the new 0-d cursor)."""
    fb = 0.84
    ap_g = 0.5
    dev = block.device
    delays = const(_COMB_DELAYS_NP, dev)
    ar4 = const(np.arange(4), dev)
    # one-element index tensors: a 0-d tensor index would be read on the
    # host
    pos = pos.long().reshape(1)
    out = []
    for x in block.unbind(0):
        rd = torch.remainder(pos - delays, _MAX_DELAY)          # [4]
        comb_out = comb[ar4, rd]                                # [4,2]
        new_vals = x[None, :] + comb_out * fb
        w = torch.remainder(pos, _MAX_DELAY)
        comb[ar4, w.expand(4)] = new_vals
        summed = torch.sum(comb_out, dim=0) * 0.25
        ra = torch.remainder(pos - _ALLPASS_DELAY, _MAX_DELAY)
        ap_out = ap[ra][0]
        ap_in = summed + ap_out * ap_g
        ap[w] = ap_in[None]
        out.append(ap_out - ap_g * ap_in)
        pos = pos + 1
    wet_sig = torch.stack(out)
    return block * (1.0 - wet) + wet_sig * wet, pos.to(torch.int32)[0]


def process(graph: BusGraph, bus_blocks, state: BusState):
    """Fold per-bus input blocks [N, B, 2] through the effect chains and
    the tree; returns (primary stereo block [B,2], new state). The state
    given is not written."""
    n = graph.num_buses
    acc = [bus_blocks[i] for i in range(n)]
    bq_x, bq_y = state.bq_x.clone(), state.bq_y.clone()
    rv_comb, rv_ap = state.rv_comb.clone(), state.rv_ap.clone()
    rv_pos = state.rv_pos.clone()
    bq_i = rv_i = 0
    out_primary = None
    for bus in graph.depth_order():
        block = acc[bus]
        for eff in graph.effects[bus]:
            if eff[0] == "biquad":
                block, nx, ny = _run_biquad(block, eff[1], bq_x[bq_i],
                                            bq_y[bq_i])
                bq_x[bq_i] = nx
                bq_y[bq_i] = ny
                bq_i += 1
            elif eff[0] == "reverb":
                block, rv_pos[rv_i] = _run_reverb(
                    block, eff[1], rv_comb[rv_i], rv_ap[rv_i], rv_pos[rv_i])
                rv_i += 1
        block = block * graph.gains[bus]
        parent = int(graph.parents[bus])
        if parent < 0:
            out_primary = block if out_primary is None else out_primary + block
        else:
            acc[parent] = acc[parent] + block
    return out_primary, BusState(bq_x, bq_y, rv_comb, rv_ap, rv_pos)
