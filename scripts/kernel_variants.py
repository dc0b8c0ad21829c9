"""Build variants of a CUDA kernel's tuning constants, for the
`*_variants.py` timing scripts.

A VARIANT is comma-separated `name=value` pairs over named constants, e.g.
`kInFlight=2,kWarpsPerBlock=4`; `base` is the source as it stands. Names of
the source's `constexpr int` constants are substituted in a copy of it;
other names are left to the calling script (a wrapper's Python constant).
Every copy is compiled at once, one nvcc each, into `build/<dir>/`, and
loaded with ctypes."""
import ctypes
import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(variant: str, names) -> dict:
    if variant == "base":
        return {}
    out = {}
    for pair in variant.split(","):
        name, value = pair.split("=")
        if name not in names:
            raise SystemExit(f"unknown constant {name}; known: {names}")
        out[name] = int(value)
    return out


def build(source, variants, cuda_names, python_names, out_dir: str, bind):
    """[(variant, constants, ctypes library)] for each variant, after
    printing ptxas's register and spill lines for it."""
    from repro_torch.kernels import common
    text0 = open(source).read()
    out_dir = os.path.join(ROOT, "build", out_dir)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = common._nvcc()
    jobs = []
    for i, variant in enumerate(variants):
        consts = parse(variant, tuple(cuda_names) + tuple(python_names))
        text = text0
        for name in cuda_names:
            if name in consts:
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {consts[name]};",
                                  text)
                if n != 1:
                    raise SystemExit(f"{name} not found in {source}")
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"v{i}.so")
        jobs.append((variant, consts, lib, subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for variant, consts, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {variant}:\n{log}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill stores" in ln]
        print(f"{variant}: {regs}", flush=True)
        handle = ctypes.CDLL(lib)
        bind(handle)
        libs.append((variant, consts, handle))
    return libs
