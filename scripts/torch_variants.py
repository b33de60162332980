"""Helpers of the scripts that time edited copies of a CUDA source on the card.

``edited`` applies a variant's text edits (each must match), ``build``
compiles several copies of one source at once with ptxas's report, each in
a directory of its own beside its own copy of a shared header where it has
one, and ``nvidia_smi`` names the card and its power limit.  Used by
``scripts/torch_fused_adam.py``.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rec_pangu_tpu_torch.ops.kernels import _build  # noqa: E402


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def edited(text: str, edits) -> str:
    """``text`` with each (old, new) edit applied; an edit that does not
    match raises, so a variant never times the source unedited."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant edit {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build(sources: dict, out_dir: str, source_name: str, header_name: str) -> tuple:
    """One nvcc a build, all started together, with ptxas's report.
    ``sources`` maps a name to (source text, header text or None); each
    build goes to ``out_dir/name/`` as ``source_name``, beside its own
    ``header_name`` when it has one (read before the package's csrc/).
    Returns (name -> loaded library, name -> ptxas's lines on its kernels)."""
    procs = {}
    for name, (text, header) in sources.items():
        folder = os.path.join(out_dir, name)
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, source_name)
        with open(path, "w") as f:
            f.write(text)
        own_header = os.path.join(folder, header_name)
        if header is not None:
            with open(own_header, "w") as f:
                f.write(header)
        elif os.path.exists(own_header):
            os.remove(own_header)
        lib = os.path.join(folder, f"lib{os.path.splitext(source_name)[0]}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC_DIR),
               "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), lib)
    libs, reports = {}, {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build:\n{err}")
        libs[name] = ctypes.CDLL(lib)
        reports[name] = [line.strip() for line in err.splitlines()
                         if "registers" in line or "spill" in line or "Compiling entry" in line]
    return libs, reports
