"""Shared by the scripts that time variants of the CUDA kernels on one card:
the card's name, CUDA-event timing, and a build of ``csrc/`` with one line
patched, loaded as the package loads its own.
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


def slope_ms(run, short: int, long: int, reps: int = 3) -> float:
    """One step as the slope between launches of ``short`` and ``long`` steps."""
    return (event_ms(lambda: run(long), reps)
            - event_ms(lambda: run(short), reps)) / (long - short)


def build_patched(_build, tag: str, filename: str, old: str, new: str):
    """Copies ``csrc/`` into ``_build/<tag>/csrc`` with the one occurrence of
    ``old`` in ``filename`` replaced by ``new``, builds the copy as the
    package builds its own sources, and returns (the loaded kernels, the
    directory holding its ``nvcc.log``). The package's own library stays
    the loaded one: set ``_build._lib`` to a variant to launch through it."""
    shipped = _build.CSRC, _build.BUILD_DIR, _build.library()
    text = (shipped[0] / filename).read_text()
    assert text.count(old) == 1, f"{old!r} is not once in {filename}"
    tree = shipped[1] / tag
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(shipped[0], tree / "csrc")
    (tree / "csrc" / filename).write_text(text.replace(old, new))
    _build.CSRC, _build.BUILD_DIR, _build._lib = tree / "csrc", tree / "lib", None
    try:
        lib = _build.library()
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._lib = shipped
    return lib, tree / "lib"


def print_ptxas(build_dir, label: str, needle: str) -> None:
    """Prints what ptxas reported (registers, spills) for every kernel whose
    mangled name holds ``needle``, from the build's ``nvcc.log``."""
    from ip_mcmc_tpu_torch.ops import _build

    for r in _build.ptxas_report(build_dir / "nvcc.log"):
        if needle in r["kernel"]:
            print(f"({label}) {r['kernel']}: {r['registers']} registers, "
                  f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads")
