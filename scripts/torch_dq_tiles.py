"""Tile sizes of the tensor-core flash dQ kernel, measured on the card:

    python3 scripts/torch_dq_tiles.py

Builds `DqTC`'s variants (warps a block, keys a tile), prints registers
and spills, holds dQ to the plain version and times each at B 64, H 8,
N 2432, Dh 64 bf16 and B 16, Dh 128. Needs a card and nvcc."""
import concurrent.futures
import ctypes
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from hidvae_tpu_torch.ops import flash_attention as fa  # noqa: E402
from hidvae_tpu_torch.utils import cuda_build as cb  # noqa: E402

WARPS = "static constexpr int WARPS = 4;                // 16 query rows each"
BN = "static constexpr int BN = DH == 64 ? 64 : 32;  // keys per streamed tile"
VARIANTS = {  # name: (old line, new line) substitutions on the source
    "as built (4 warps; 64 keys at Dh 64, 32 at Dh 128)": [],
    "8 warps": [(WARPS, "static constexpr int WARPS = 8;")],
    "32 keys at both widths": [(BN, "static constexpr int BN = 32;")],
    "8 warps, 32 keys": [(WARPS, "static constexpr int WARPS = 8;"),
                         (BN, "static constexpr int BN = 32;")],
    "64 keys at both widths": [(BN, "static constexpr int BN = 64;")],
}


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(
            lambda a: (a[1][0], *cb.build_variant("flash_attention.cu", f"dq_tiles_{a[0]}", a[1][1])),
            enumerate(VARIANTS.items())))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    real_build = fa.build
    cases = {}
    for dh, b in ((64, 64), (128, 16)):
        q, k, v, do, seg = cs.flash_inputs(b, 8, 2432, torch.bfloat16, dev, g, dh)
        o, m, l = fa.flash_fwd(q, k, v, seg, seg, False, dh ** -0.5)
        di = torch.sum(o.float() * do.float(), dim=-1)
        sl = slice(0, 2)
        ref = fa.flash_bwd_dq_reference(q[sl], k[sl], v[sl], seg[sl], seg[sl], do[sl], m[sl],
                                        l[sl], di[sl], False, dh ** -0.5)
        cases[dh] = (q, k, v, do, seg, m, l, di, ref)
    for name, path, log in built:
        print(f"== {name}", flush=True)
        if path is None:
            print(log, flush=True)
            continue
        for line in cs.ptxas_report(log):
            if line.startswith("flash_bwd_dq_tc_kernel"):
                print(f"  {line}", flush=True)
        ns = types.SimpleNamespace(lib=ctypes.CDLL(path))
        fa.bind(ns.lib)
        fa.build = lambda: ns
        for dh, (q, k, v, do, seg, m, l, di, ref) in cases.items():
            call = lambda: fa.flash_bwd_dq(q, k, v, seg, seg, do, m, l, di, False, dh ** -0.5)
            got = call()
            torch.cuda.synchronize()
            err = float((got[:2].float() - ref.float()).abs().max())
            lim = cs.FLASH_RTOL[torch.bfloat16] * float(ref.float().abs().max())
            ms = [cs.median_ms(call) for _ in range(2)]
            print(f"  Dh {dh} B {q.shape[0]}: dQ err {err:.3e} (limit {lim:.3e}"
                  f"{'' if err <= lim else ', FAILS'}) ms {ms[0]:.4f} {ms[1]:.4f}", flush=True)
        fa.build = real_build


if __name__ == "__main__":
    main()
