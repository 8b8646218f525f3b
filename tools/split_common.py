"""What the kernel-split tools share: text cuts of a kernel source, their build, and timing.

``gather_split.py`` and ``topk_split.py`` measure where a kernel's time goes
by building variants of its source with one part cut out and timing each.
A variant's results are wrong by design; only its time is read.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path


def variant_source(text: str, edits, tool: str) -> str:
    """Apply ``edits``, a list of (pattern, replacement), to a kernel
    source; each pattern must be found in it."""
    for pattern, replacement in edits:
        if pattern not in text:
            raise SystemExit(f"{tool}: {pattern!r} not found in the kernel source")
        text = text.replace(pattern, replacement)
    return text


def build_variants(build, source: Path, variants: dict, out: Path, tool: str) -> dict:
    """Write one copy of ``source`` per variant (with the headers beside it)
    under ``out`` and build them all at once with ``build`` (the tree's
    ``_build.build``). Returns {variant: library path}."""
    text = source.read_text()
    sources = {}
    for name, edits in variants.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in source.parent.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / source.name).write_text(variant_source(text, edits, tool))
        sources[name] = d / source.name
    build(list(sources.values()))
    return sources


def register_lines(lib_log: Path, kernel_re: str):
    """(kernel, ptxas line) for each register or spill line of the kernels
    whose mangled name matches ``kernel_re`` in a library's build log."""
    kernel = None
    for line in lib_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1) if re.search(kernel_re, m.group(1)) else None
        elif kernel and ("registers" in line or "spill" in line):
            yield kernel, line.replace("ptxas info    :", "").strip()


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up, by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_kernels(fn, reps: int, kernel_re: str) -> str:
    """The device ms per call of each kernel matching ``kernel_re``, by
    ``torch.profiler``, or "no device time" where it sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
        m = re.search(kernel_re, ev.key or "")
        if dev_us and m:
            rows.append(f"{m.group(0)} {dev_us / 1e3 / reps:.3f} ms")
    return "; ".join(rows) if rows else "no device time"
