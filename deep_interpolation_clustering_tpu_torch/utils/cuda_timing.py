"""Device time of one call on the card, as `chip_smoke.py` and the biLSTM
rows-per-block sweep (`utils/lstm_rows_sweep.py`) read it."""

from __future__ import annotations

import time

import numpy as np
import torch

L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
SPIN_CYCLES = 4_000_000  # ~2 ms at the boost clock


def time_ms(fn, reps: int = 50, warmup_s: float = 0.2) -> float:
    """Median over `reps` calls of `fn`, each between two CUDA events and
    each after the L2 cache was flushed (the bound counts device-memory
    bytes). Before each start event the card spins for about 2 ms, so the
    host has queued all of `fn`'s launches before the card reaches them:
    the events then time the device's work, not the host's launch
    overhead. A warm-up of `warmup_s` seconds first brings the card's clocks
    up from idle."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))
