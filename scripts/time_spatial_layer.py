"""Times `fused_spatial_layer` of one checkout of the port on the card.

At the op phase's three shapes and the near one-hot site of `chip_smoke.py`,
it runs the kernels phase's check of the layer (`chip_smoke.spatial_layer_check`:
the kernels against the plain twin within its limits, the kernel's and the
twin's median times, the bound, the MUFU bound, the two products through
cuBLAS and the composed library path), and adds a bitwise rerun and the
device kernels of one call (torch.profiler).

    python scripts/time_spatial_layer.py --root DIR --label NAME [--out FILE]

--root is the checkout whose `viewcrafter_tpu_torch` is imported: an older
tree unpacked with `git archive` beside this one compares two versions on one
card (run old, new, new, old in one call, one process each). One JSON object
with the build's ptxas registers and spills for the wgmma kernels, and any
note of ptxas that it serialised their wgmma, then one per site, go to
stdout (the sites also to FILE with --out). Exits non-zero if a site is
outside the check's limits or a rerun differs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke  # this checkout's: the check, the yardsticks and the bound
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("time_spatial_layer: no CUDA device", file=sys.stderr)
        return 2
    from viewcrafter_tpu_torch.ops.kernels import _lib, spatial_layer

    assert Path(spatial_layer.__file__).resolve().is_relative_to(root), spatial_layer.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi("name,power.limit")
    peaks = chip_smoke.card_peaks(torch.cuda.get_device_name(0))
    mufu_rate = chip_smoke.mufu_exp_per_s(float(chip_smoke.nvidia_smi("clocks.max.sm", "nounits")))
    _lib.lib()
    notes = [ln.split("Potential Performance Loss: ")[-1][:200] for ln in _lib.build_log.splitlines()
             if "Performance Loss" in ln]
    print(json.dumps({"label": args.label, "ptxas": chip_smoke.wgmma_kernel_resources(_lib.build_log),
                      "serialization_notes": notes}), flush=True)

    def check(name, site, got, ref, kernel, *rest, **kw):
        res = chip_smoke.check_kernel(name, site, got, ref, kernel, *rest, peaks=peaks,
                                      mufu_rate=mufu_rate, **kw)
        return {"label": args.label, **res, "rerun_bit_equal": bool(torch.equal(got, kernel())),
                "device_kernels_per_call": chip_smoke.device_kernels_per_call(kernel),
                "nvidia_smi": smi}

    randn = chip_smoke.seeded_randn(torch.Generator(device="cuda").manual_seed(0))
    sites = [(s, None) for s in chip_smoke.SPATIAL_OP_SHAPES] + [
        (chip_smoke.PEAKY_SITES["fused_spatial_layer"], 4.0)]
    out = open(args.out, "a") if args.out else None
    ok = True
    for site, w_mul in sites:
        with torch.no_grad():
            res = chip_smoke.spatial_layer_check(spatial_layer, randn, site, check, w_mul)
        line = json.dumps(res)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        try:
            chip_smoke.within_limits(res)
        except AssertionError as exc:
            print(exc, file=sys.stderr)
            ok = False
        ok = ok and res["rerun_bit_equal"]
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
