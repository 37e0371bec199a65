"""Time the RNNT alpha and beta lattices on the card, for any checkout.

    python3 indic_cl_asr_torch/tools/profile_lattice.py [ROOT] [--variants]

Runs ``rnnt_alpha`` and ``rnnt_beta`` of the port found under ROOT
(default: this checkout) on seeded slabs (``chip_smoke.lattice_inputs``,
through ``_prepare``): B16 T204 U+1 129 with phase 3's lengths (the
training step's shape), the same with every row full, B16 T104 U+1 65 (a
CL eval batch's shape) and B4 T64 U+1 600 (``chip_smoke.LATTICE_ABOVE``,
above the warp kernels' U+1). Each call is timed three ways
(``chip_smoke.py``'s helpers): CUDA events over eager calls, CUDA events
over a CUDA graph of 20 calls (no host time between launches: the launch
is ~0.03 ms, as long as the host's wrapper) and the kernel's profiled
device time, with the max abs error on finite entries against the plain
version and the roofline bound (``chip_smoke.bound_ms`` of
``rnnt_loss.work``).

Then, from this checkout's ``csrc/rnnt_lattice.cu`` whatever ROOT is, the
chain floor: ``rnnt_chain_floor``, one warp running the alpha kernel's
per-diagonal arithmetic (the shuffle, two adds and a logaddexp a column)
for 331 dependent diagonals (alpha's at T204 U+1 129) with no loads, at 1
column a lane (the latency of the chain) and at 5 (the arithmetic one
warp issues a diagonal at U+1 129-160), and 167 diagonals at 3 columns
(U+1 65, T104), over a CUDA graph of 20 launches and on the device.

``--variants`` also builds this checkout's source with
``-DLATTICE_WARP_MAX_U1=0`` (the block kernels at every U+1) and times it
beside the default build at B16 T204 U+1 129 and at U+1 160, the warp
kernels' largest. The procedure is this
checkout's, so two checkouts are measured the same way: run it for each,
in turns, on one card. Prints one JSON line. Needs a CUDA card; exits 2
without one.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CASES = {
    "B16 T204 U+1 129": dict(),
    "B16 T204 U+1 129 full": dict(t_lens=[204] * 16, u_lens=[128] * 16),
    "B16 T104 U+1 65": dict(T=104, U1=65, t_lens=[104] * 12 + [1, 80, 60, 104],
                            u_lens=[64, 0, 30, 1] * 4),
}
# chain floors: (diagonals, columns a lane)
FLOORS = ((331, 1), (331, 5), (167, 3))


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_here(defines=()):
    """This checkout's rnnt_lattice.cu with ``defines``, built as
    ops/_build.py builds it, into build/profile_lattice/; (library, ptxas
    lines)."""
    b = _module("lattice_build_here", os.path.join(HERE, "indic_cl_asr_torch", "ops", "_build.py"))
    src = os.path.join(b.CSRC, "rnnt_lattice.cu")
    tag = hashlib.sha256(open(src, "rb").read() + repr(defines).encode()).hexdigest()[:12]
    out_dir = os.path.join(HERE, "build", "profile_lattice")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"librnnt_lattice-{tag}.so")
    cmd = [b.nvcc_path(), "-gencode", b.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-Xptxas", "-v", "-o", out, src, *(f"-D{d}" for d in defines)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {defines}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rnnt_alpha.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.rnnt_beta.argtypes = [vp, vp, vp, vp, i, i, i, vp]
    lib.rnnt_chain_floor.argtypes = [vp, vp, i, i, vp]
    return lib, ptxas_by_kernel(proc.stdout + proc.stderr)


def ptxas_by_kernel(log):
    """{kernel: "N registers, M bytes spilled"} from ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"((?:alpha|beta)_(?:warp|block)|chain_floor|lae_check)_kernel"
                          r"(?:ILi(\d+)E)?", m.group(1))
            name = m.group(1) if not k else k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            out[name] = {"spill_bytes": int(m.group(1))}
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def lib_calls(lib, lpb, lpl, ul):
    """(alpha, beta) calls of a directly loaded library on the prepared
    slabs: the wrapper's allocation and launch, without its checks."""
    import torch

    B, T, U1 = lpb.shape
    ul32 = ul.to(torch.int32).contiguous()

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def alpha():
        out = torch.empty_like(lpb)
        if lib.rnnt_alpha(lpb.data_ptr(), lpl.data_ptr(), out.data_ptr(), B, T, U1, stream()):
            raise RuntimeError("rnnt_alpha failed")
        return out

    def beta():
        out = torch.empty((B, T + 1, U1), dtype=torch.float32, device=lpb.device)
        if lib.rnnt_beta(lpb.data_ptr(), lpl.data_ptr(), ul32.data_ptr(), out.data_ptr(), B, T,
                         U1, stream()):
            raise RuntimeError("rnnt_beta failed")
        return out

    return alpha, beta


def timings(cs, fn, plain, kernel):
    got, want = fn(), plain()
    fin = want > -5e29
    if not bool((fin == (got > -5e29)).all()):
        raise AssertionError(f"{kernel}: finite entries differ from the plain version's")
    return {"ms": cs.cuda_ms(fn), "graph_ms": cs.cuda_graph_ms(fn),
            "device_ms": cs.device_ms(fn, kernel),
            "max_abs_err": (got[fin] - want[fin]).abs().max().item()}


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else HERE)
    sys.path.insert(0, root)  # the port under test, before anything imports it
    import torch

    if not torch.cuda.is_available():
        print("profile_lattice: no CUDA device is available", file=sys.stderr)
        return 2
    cs = _module("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    import indic_cl_asr_torch
    from indic_cl_asr_torch.ops import rnnt_loss as R

    dev = torch.device("cuda", 0)
    out = {"root": root, "package": os.path.dirname(indic_cl_asr_torch.__file__),
           "card": cs.nvidia_smi(), "cases": {}}
    cases = {**CASES, "B4 T64 U+1 600": cs.LATTICE_ABOVE}
    prepared = {}
    for name, case in cases.items():
        lb, ll, tl, ul = cs.lattice_inputs(dev, **case)
        lpb, lpl, _, _ = R._prepare(lb, ll, tl, ul)
        prepared[name] = (lpb, lpl, ul)
        B, T, U1 = lpb.shape
        kernel = R.lattice_kernel(U1) if hasattr(R, "lattice_kernel") else "block"
        rec = {"kernel": kernel}
        for which, fn, plain in (
                ("alpha", lambda: R.rnnt_alpha(lpb, lpl), lambda: R._alpha_scan(lpb, lpl)),
                ("beta", lambda: R.rnnt_beta(lpb, lpl, ul), lambda: R._beta_scan(lpb, lpl, ul))):
            b_ms, b_by = cs.bound_ms(*R.work(B, T, U1, beta=which == "beta"))
            rec[which] = {**timings(cs, fn, plain, which), "bound_ms": b_ms, "bound_by": b_by}
        out["cases"][name] = rec

    lib, ptxas = build_here()
    out["ptxas"] = ptxas
    out["chain_floor"] = {}
    for steps, cols in FLOORS:
        g = torch.Generator().manual_seed(steps * 10 + cols)
        x = torch.cat([-torch.rand(32 * cols, generator=g) * 100,
                       -torch.rand(64 * cols, generator=g) * 3]).to(dev)
        y = torch.empty(32 * cols, device=dev)

        def floor():
            if lib.rnnt_chain_floor(x.data_ptr(), y.data_ptr(), steps, cols,
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)):
                raise RuntimeError("rnnt_chain_floor failed")

        out["chain_floor"][f"{steps} diagonals x {cols} columns"] = {
            "graph_ms": cs.cuda_graph_ms(floor), "device_ms": cs.device_ms(floor, "chain_floor")}

    if "--variants" in sys.argv:
        out["variants"] = {}
        lpb, lpl, ul = prepared["B16 T204 U+1 129"]
        w = lib.rnnt_lattice_warp_max_u1()
        wide = cs.lattice_inputs(dev, U1=w, u_lens=[w - 1, 0, 64, 1] * 4)
        wide = (*R._prepare(*wide)[:2], wide[3])
        for name, defines in (("default", ()), ("block", ("LATTICE_WARP_MAX_U1=0",))):
            vlib, vptxas = (lib, ptxas) if not defines else build_here(defines)
            rec = {"defines": list(defines), "ptxas": vptxas}
            for label, (a, b, u) in (("B16 T204 U+1 129", (lpb, lpl, ul)),
                                     (f"B16 T204 U+1 {w}", wide)):
                alpha, beta = lib_calls(vlib, a, b, u)
                rec[label] = {
                    "alpha": timings(cs, alpha, lambda: R._alpha_scan(a, b), "alpha"),
                    "beta": timings(cs, beta, lambda: R._beta_scan(a, b, u), "beta")}
            out["variants"][name] = rec
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
