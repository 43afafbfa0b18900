"""Card timing shared by the tools that time kernels side by side
(`*_ab.py`, `chunk_scan_variants.py`): CUDA-event and CUDA-graph means of
one call, and the card's name and power limit."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 200, warmup: int = 3) -> float:
    """Mean ms of `fn()` on the card, by CUDA events over `reps` raw calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Mean ms of one `fn()` with no host gaps: `launches` calls captured in
    one CUDA graph, replayed `reps` times between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * launches)
