"""Shared by the scripts that time variants of the CUDA kernels on one card:
the card's name, CUDA-event and profiler timing, and builds of ``csrc/``
with lines patched, loaded as the package loads its own.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def card_line() -> str:
    """Name and power limit of the card, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def event_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, needles) -> float | None:
    """Device time of one call of ``fn``: the time that torch.profiler
    (CUPTI) records in the kernels whose names hold one of ``needles``, over
    ``reps`` calls after a warm-up, divided by ``reps``; None when it
    records none. A small call's CUDA-event time (``event_ms``) can be the
    host's time to issue it; this is the card's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
             for e in prof.key_averages() if any(n in e.key for n in needles))
    return us / reps / 1e3 if us else None


def slope_ms(run, short: int, long: int, reps: int = 3) -> float:
    """One step as the slope between launches of ``short`` and ``long`` steps."""
    return (event_ms(lambda: run(long), reps)
            - event_ms(lambda: run(short), reps)) / (long - short)


def print_ptxas(build_dir, label: str, needle: str) -> None:
    """Prints what ptxas reported (registers, spills) for every kernel whose
    mangled name holds ``needle``, from the build's ``nvcc.log``."""
    from ip_mcmc_tpu_torch.ops import _build

    for r in _build.ptxas_report(build_dir / "nvcc.log"):
        if needle in r["kernel"]:
            print(f"({label}) {r['kernel']}: {r['registers']} registers, "
                  f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")


def build_designs(_build, filename: str, units, shipped: str, designs: dict, tag: str) -> dict:
    """Builds ``units`` (``.cu`` names) of a copy of ``csrc/`` once for each
    design, the one line ``shipped`` of ``filename`` replaced by the
    design's line, every compiler started together: {key of ``designs``:
    (library paths, the directory holding its ``nvcc.log``)}, or {key: the
    compiler's first error} for a design that does not build (a
    static_assert of the design)."""
    return build_patch_sets(_build, units, {key: [(filename, shipped, line)]
                                            for key, line in designs.items()}, tag)


def build_patch_sets(_build, units, designs: dict, tag: str) -> dict:
    """As ``build_designs``, a design being a list of patches (file name,
    text that is once in it, its replacement) applied in order."""
    procs = []
    for key, patches in designs.items():
        tree = _build.BUILD_DIR / f"{tag}_{len(procs)}"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(_build.CSRC, tree / "csrc")
        for filename, old, new in patches:
            path = tree / "csrc" / filename
            text = path.read_text()
            assert text.count(old) == 1, f"{old!r} is not once in {filename}"
            path.write_text(text.replace(old, new))
        (tree / "lib").mkdir()
        for unit in units:
            so = tree / "lib" / f"libipx_{unit[:-3]}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(tree / "csrc"), "-o", str(so),
                   str(tree / "csrc" / unit)]
            procs.append((key, cmd, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
    out, logs, failed = {}, {}, {}
    for key, cmd, so, proc in procs:
        log = " ".join(cmd) + "\n" + proc.communicate()[0]
        logs.setdefault(key, []).append(log)
        if proc.returncode != 0:
            failed.setdefault(key, next((ln.strip() for ln in log.splitlines() if "error" in ln),
                                        "nvcc failed"))
        out.setdefault(key, []).append(so)
    for key, parts in logs.items():
        (out[key][0].parent / "nvcc.log").write_text("\n".join(parts))
    return {key: failed.get(key) or (sos, sos[0].parent) for key, sos in out.items()}


def load_with(_build, sos):
    """The package's kernels with the libraries of some units swapped for
    ``sos`` (``libipx_<unit>.so``; the other units as shipped)."""
    swap = {so.name.rsplit(".", 1)[0]: so for so in sos}
    # the package's libraries are libipx_<unit>_<digest>.so
    paths = [swap.get(p.name.rsplit("_", 1)[0], p) for p in _build.build()]
    build, lib = _build.build, _build._lib
    _build.build, _build._lib = (lambda: paths), None
    try:
        return _build.library()
    finally:
        _build.build, _build._lib = build, lib


def ptxas_row(build_dir, *needles: str):
    """What ptxas reported for the first kernel whose mangled name holds
    every one of ``needles`` in the build's ``nvcc.log``: (registers, spill
    stores, spill loads), or None."""
    from ip_mcmc_tpu_torch.ops import _build

    for r in _build.ptxas_report(build_dir / "nvcc.log"):
        if all(n in r["kernel"] for n in needles):
            return r["registers"], r["spill_stores"], r["spill_loads"]
    return None
