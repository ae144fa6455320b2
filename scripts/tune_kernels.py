"""Time the B5 (Schur) kernel of gslam_tpu_torch over its tuning
constants, and B3 (matcher) as built, on one NVIDIA card.

    python3 scripts/tune_kernels.py

``csrc/schur.cu`` takes its threads per block and its most points per
group from ``-DGSLAM_SCHUR_THREADS`` and ``-DGSLAM_SCHUR_GROUP``; each
variant is built into its own library and timed by CUDA-graph replay
(``chip_smoke.graph_ms``) at the local-BA shape (C = 8, P = 1024,
O = 8), the widest contract shape (C = 32) and the loop run's (C = 4,
P = 384), after a check against the plain version.  Prints one JSON
line with the card's name and power limit.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gslam_tpu_torch.ops.cuda import build, matcher, schur  # noqa: E402
from gslam_tpu_torch.opt import ba  # noqa: E402

VARIANTS = [(256, 8), (256, 4), (256, 16), (128, 8), (512, 8), (512, 16)]


def kernel_split(fn, calls: int = 20):
    """Mean device microseconds of each CUDA kernel ``fn`` launches, by
    name, from torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            # "void (anonymous namespace)::schur_groups<false>(...)"
            name = ev.name.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0].split("<")[0][-40:]
            by_name[name] = by_name.get(name, 0.0) \
                + ev.time_range.elapsed_us() / calls
    return {k: round(v, 3) for k, v in by_name.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_kernels: needs an NVIDIA card", file=sys.stderr)
        return 1
    card = cs.card_name_and_power_limit()
    lam = torch.tensor(1e-3, device="cuda")
    bench = cs.bench_problem()
    probs = {"C8_P1024_O8": (bench, bench)}    # (as given, without pads)
    for label, case in cs.SCHUR_EXTRA.items():
        fields = cs.ba_case(**case, seed=1)
        probs[label] = (cs.to_problem(fields, "cuda"), cs.to_problem(
            cs.without_pad_indices(fields), "cuda"))
    flags = build.NVCC_FLAGS
    out = {"card": card, "schur_ms": {}, "matcher_ms": {}}
    for threads, group in VARIANTS:
        build.NVCC_FLAGS = flags + (f"-DGSLAM_SCHUR_THREADS={threads}",
                                    f"-DGSLAM_SCHUR_GROUP={group}")
        build._LIBS.pop("schur", None)
        schur._lib.cache_clear()
        row = {}
        for label, (prob, plain) in probs.items():
            cs.assert_schur_close(schur.schur_reduce_kernel(prob, lam, 0.01),
                                  ba.schur_reduce(plain, lam, 0.01), label)
            row[label] = min(cs.graph_ms(
                lambda: schur.schur_reduce_kernel(prob, lam, 0.01))
                for _ in range(2))
            if (threads, group) == VARIANTS[0]:
                print(f"  {label} kernels (us):", kernel_split(
                    lambda: schur.schur_reduce_kernel(prob, lam, 0.01)),
                    flush=True)
        out["schur_ms"][f"T{threads}_G{group}"] = row
        print(f"schur threads {threads} group {group}: {row}", flush=True)
    build.NVCC_FLAGS = flags
    for N, M in ((2048, 512), (333, 1000), (8192, 2048)):
        args = [torch.as_tensor(x, device="cuda")
                for x in cs.matcher_case(N, M, "ties", seed=5)]
        out["matcher_ms"][f"N{N}_M{M}"] = min(cs.graph_ms(
            lambda: matcher.hamming_top2_kernel(*args)) for _ in range(2))
        print(f"  N={N} M={M} kernels (us):", kernel_split(
            lambda: matcher.hamming_top2_kernel(*args)), flush=True)
    print(f"matcher: {out['matcher_ms']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
