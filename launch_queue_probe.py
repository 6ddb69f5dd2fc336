"""How many launches the host can queue behind a spin kernel before the
card's queue of pending launches is full and the host blocks.

`chip_smoke.device_ms` times a set of calls queued behind
`torch.cuda._sleep`. For each set size N this script queues N of PyTorch's
smallest launches (an add into a 16-float tensor) behind spins of 2^24,
2^26, ... 2^32 cycles and prints the shortest spin that covered the set,
or None with the host's seconds of the last try where none did (the host
then waited for the whole spin). It then times sets of 800 and 3,000 such
calls through `chip_smoke.device_ms`, which halves a set that no spin
covers, and prints what it halved.

    python3 launch_queue_probe.py        # on a machine with a CUDA card
"""
import time

import torch

import chip_smoke

SIZES = (200, 600, 800, 1000, 1200, 1600, 3000)


def shortest_spin(fn, reps):
    """(cycles of the shortest spin behind which the host queued reps calls
    of fn, or None, and the host's seconds to queue the last try)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return cycles, host_s
        if cycles >= 1 << 32:
            return None, host_s
        cycles <<= 2


def main():
    chip_smoke.phase_device()
    x = torch.zeros(16, device="cuda")
    y = torch.zeros(16, device="cuda")

    def add():
        torch.add(x, 1.0, out=y)

    for n in SIZES:
        cycles, host_s = shortest_spin(add, n)
        print(f"{n} launches: shortest spin {cycles} cycles, host "
              f"{host_s:.4f} s to queue the last try", flush=True)
    for n in (800, 3000):
        chip_smoke.DEVICE_MS_HALVED.clear()
        ms = chip_smoke.device_ms(add, n)
        print(f"device_ms of {n} calls: {ms:.6f} ms a call; halved "
              f"(caller's line, reps asked, reps timed): "
              f"{chip_smoke.DEVICE_MS_HALVED}", flush=True)
    print(chip_smoke.CARD)


if __name__ == "__main__":
    main()
