"""Tile shapes of the rq_assign kernel, measured on the card:

    python3 scripts/torch_rq_tiles.py [--parent OLD/rq_assign.cu]

Builds `Cfg`'s variants (warps, unroll, micro-tile), prints registers and
spills, runs each (and --parent) at L 3, K 256, B 8,192 and 1,048,576,
D 32 and 64, bitwise against the first, timed. Needs a card and nvcc."""
import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from hidvae_tpu_torch.utils import cuda_build as cb  # noqa: E402

WARPS = "static constexpr int WARPS = D == 32 ? 16 : (D == 64 ? 12 : 4);"
NG = "static constexpr int NG = 2;"
UNROLL = "static constexpr int UNROLL = 8;"
VARIANTS = {  # name: (old line, new line) substitutions on the source
    "as built (16 warps at D 32, 12 at D 64; 4 x 8 a lane; d unrolled 8)": [],
    "d unrolled 4": [(UNROLL, "static constexpr int UNROLL = 4;")],
    "8 warps at D 32": [(WARPS, "static constexpr int WARPS = D == 32 ? 8 : (D == 64 ? 12 : 4);")],
    "8 warps at D 64": [(WARPS, "static constexpr int WARPS = D == 32 ? 16 : (D == 64 ? 8 : 4);")],
    "14 warps at D 64": [(WARPS, "static constexpr int WARPS = D == 32 ? 16 : (D == 64 ? 14 : 4);")],
    "4 x 4 a lane": [(NG, "static constexpr int NG = 1;")],
}
SHAPES = ((8192, 32, 3, 256), (1048576, 32, 3, 256), (8192, 64, 3, 256), (1048576, 64, 3, 256))


def launcher(path):
    """rq_assign through the library at `path`: x, codebooks -> ids, qsum."""
    fn = ctypes.CDLL(path).rq_assign_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, cbs):
        ids = torch.empty((x.shape[0], cbs.shape[0]), dtype=torch.int32, device=x.device)
        qsum = torch.empty_like(x)
        err = fn(x.data_ptr(), cbs.data_ptr(), ids.data_ptr(), qsum.data_ptr(), x.shape[0],
                 x.shape[1], cbs.shape[0], cbs.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return ids, qsum
    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier rq_assign.cu to time and compare with")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    jobs = [(name, subs, None) for name, subs in VARIANTS.items()]
    if args.parent:
        jobs.append(("parent", [], os.path.abspath(args.parent)))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda a: (a[1][0], *cb.build_variant(
            "rq_assign.cu", f"rq_tiles_{a[0]}", a[1][1], a[1][2])), enumerate(jobs)))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    inputs = []
    for b, d, n_levels, k in SHAPES:
        x = torch.randn(b, d, device=dev, generator=g)
        x = x / x.norm(dim=-1, keepdim=True)
        cbs = torch.randn(n_levels, k, d, device=dev, generator=g) * 0.5
        cbs[0] = cbs[0] / cbs[0].norm(dim=-1, keepdim=True)
        inputs.append((x, cbs))
    runs = {}
    for name, path, log in built:
        print(f"== {name}", flush=True)
        if path is None:
            print(log, flush=True)
            continue
        for line in cs.ptxas_report(log):
            print(f"  {line}", flush=True)
        runs[name] = launcher(path)
    first = next(iter(VARIANTS))
    want = [runs[first](x, cbs) for x, cbs in inputs]
    order = list(runs)
    if "parent" in runs:  # parent, variants, parent
        order = ["parent", *[n for n in order if n != "parent"], "parent"]
    for name in order:
        for (x, cbs), (ids_w, q_w), (b, d, n_levels, k) in zip(inputs, want, SHAPES):
            ids, qsum = runs[name](x, cbs)
            torch.cuda.synchronize()
            same = bool(torch.equal(ids, ids_w) and torch.equal(qsum.view(torch.int32),
                                                                q_w.view(torch.int32)))
            call = lambda: runs[name](x, cbs)  # noqa: E731
            ms = [cs.graph_ms(call) for _ in range(2)]
            bound, by = cs.rq_bound_ms(b, d, n_levels, k)
            print(f"  {name}: B {b} D {d}: ids and qsum bitwise equal to '{first}': {same}; "
                  f"graph ms {ms[0]:.4f} {ms[1]:.4f} (bound {bound:.4f}, {by}: "
                  f"{100 * bound / min(ms):.1f} %); call ms {cs.median_ms(call):.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
