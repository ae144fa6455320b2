"""Time hand-written kernels of gslam_tpu_torch over their tuning
constants on one NVIDIA card.

    python3 scripts/tune_kernels.py [b1] [b4] [b5] [b3]

(all four when none is named).  A source takes its tuning constants as
``-D`` macros at build time, the chosen values being its defaults:

- ``csrc/fastnms.cu`` (B1): the output tile ``GSLAM_FAST_TW`` x
  ``GSLAM_FAST_TH`` and ``GSLAM_FAST_THREADS`` per block; timed on
  ``track_forward``'s example image (480 x 640, threshold 0.06) and the
  first frame of the 64-frame SLAM sequence (threshold 0.08), arc 9;
- ``csrc/gated.cu`` (B4): ``GSLAM_GATED_WARPS`` per block,
  ``GSLAM_GATED_ROWS`` map rows per warp, ``GSLAM_GATED_UNROLL`` columns
  a lane tests per step and ``GSLAM_GATED_TILE`` keypoints staged per
  step;
  timed at N = 2048, M = 512 (the main path),
  N = 768, M = 384 (the loop run) and N = 2048, M = 2500;
- ``csrc/schur.cu`` (B5): ``GSLAM_SCHUR_THREADS`` per block and
  ``GSLAM_SCHUR_GROUP`` points per group; timed at C = 8, P = 1024,
  O = 8, at C = 32 and at the loop run's C = 4, P = 384.

Every variant is built into its own library (one ``nvcc`` each, all
started together; their register and shared-memory lines are printed),
checked against the plain version (B1 and B4 bit for bit, B5 within
``chip_smoke.assert_schur_close``), then timed by CUDA-graph replay
(``chip_smoke.graph_ms``, the better of two).  The first variant of each
list is the source's default; its time is split by kernel name with
torch.profiler.  B3 is timed as built.  The last line is one JSON object
with the card's name and power limit.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gslam_tpu_torch.models.graft import example_image  # noqa: E402
from gslam_tpu_torch.ops.cuda import (  # noqa: E402
    build, fastnms, matcher, schur,
)
from gslam_tpu_torch.ops.matching import hamming_top2_gated  # noqa: E402
from gslam_tpu_torch.opt import ba  # noqa: E402

# (tile width, tile height, threads); 480 x 640 takes 100 blocks of
# 64 x 48, 120 of 64 x 40 or 128 x 20, 150 of 64 x 32, 240 of 64 x 20,
# 300 of 32 x 32, 480 of 32 x 20, 600 of 32 x 16 (the first design's
# tile)
FAST_VARIANTS = [(64, 40, 1024), (64, 40, 512), (64, 40, 256),
                 (64, 48, 1024), (64, 32, 1024), (128, 20, 1024),
                 (64, 20, 512), (32, 32, 256), (32, 20, 256),
                 (32, 16, 256), (128, 16, 512)]
# (warps per block, rows per warp, columns a lane tests per step, tile);
# a block takes warps x rows map rows, and its shared memory (tile and
# queues) must fit in 48 kB
GATED_VARIANTS = [(16, 1, 4, 512), (8, 1, 4, 512), (8, 2, 4, 512),
                  (16, 2, 4, 512), (4, 2, 4, 512), (16, 1, 2, 512),
                  (16, 1, 8, 512), (32, 1, 4, 256), (16, 1, 4, 256)]
GATED_SHAPES = ((2048, 512), (768, 384), (2048, 2500))
# (threads per block, points per group)
SCHUR_VARIANTS = [(512, 8), (256, 8), (256, 4), (256, 16), (128, 8),
                  (512, 16)]


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
                "void ", "").split("(")[0][-40:]
            by_name[name] = by_name.get(name, 0.0) \
                + ev.time_range.elapsed_us() / calls
    return {k: round(v, 3) for k, v in by_name.items()}


def build_variants(name, variants):
    """Build ``name`` once per variant (a tuple of ``-D`` flags), one
    ``nvcc`` each, all at once; print each build's resource lines."""
    base = build.NVCC_FLAGS
    with ThreadPoolExecutor(len(variants)) as ex:
        logs = list(ex.map(
            lambda v: build.build_all((name,), flags=base + v)[name],
            variants))
    for v, text in zip(variants, logs):
        print(f"{name} {' '.join(v)}:", flush=True)
        for line in cs.resource_lines(name, text):
            print(line, flush=True)


def use_variant(name, lib_fn, flags):
    """Make the wrapper whose cached loader is ``lib_fn`` load the
    library of ``name`` built with ``flags`` added."""
    build.NVCC_FLAGS = BASE_FLAGS + flags
    build._LIBS.pop(name, None)
    lib_fn.cache_clear()


def best_ms(fn):
    return min(cs.graph_ms(fn) for _ in range(2))


def tune(name, lib_fn, variants, to_flags, cases, check, call):
    """Each variant of ``name``: checked on every case, then timed;
    the first (default) variant split by kernel name."""
    flags = [to_flags(v) for v in variants]
    build_variants(name, flags)
    out = {}
    for v, f in zip(variants, flags):
        use_variant(name, lib_fn, f)
        row = {}
        for label, args in cases.items():
            check(label, args)
            row[label] = best_ms(lambda: call(args))
            if v == variants[0]:
                print(f"  {label} kernels (us):",
                      kernel_split(lambda: call(args)), flush=True)
        out["_".join(map(str, v))] = row
        print(f"{name} {v}: {row}", flush=True)
    use_variant(name, lib_fn, ())
    return out


def tune_fast():
    img = torch.as_tensor(example_image(cs.H, cs.W)[0], device="cuda")
    ds = cs.SyntheticDataset(**cs.SEQUENCE)
    ds.open("synth://")
    frame = torch.as_tensor(ds.grab_frame().image, device="cuda")
    cases = {"example_t0.06": (img, cs.THRESH),
             "slam_frame_t0.08": (frame, cs.SLAM_CFG["fast_threshold"])}

    def check(label, args):
        k, p = fastnms.fast_nms_raw(*args), fastnms.fast_nms_plain(*args)
        if not (torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])):
            raise AssertionError(f"B1 variant disagrees ({label})")

    return tune("fastnms", fastnms._lib, FAST_VARIANTS,
                lambda v: tuple(f"-DGSLAM_FAST_{k}={x}" for k, x in zip(
                    ("TW", "TH", "THREADS"), v)),
                cases, check, lambda a: fastnms.fast_nms_raw(*a))


def tune_gated():
    gate2 = cs.gate_squared(cs.SLAMConfig().gate_radius_px)
    cases = {f"N{N}_M{M}": (*cs.gated_inputs(N, M), gate2)
             for N, M in GATED_SHAPES}

    def check(label, args):
        k, p = matcher.gated_top2_kernel(*args), hamming_top2_gated(*args)
        if not all(torch.equal(a, b.to(a.dtype)) for a, b in zip(k, p)):
            raise AssertionError(f"B4 variant disagrees ({label})")

    return tune("gated", matcher._gated_lib, GATED_VARIANTS,
                lambda v: tuple(f"-DGSLAM_GATED_{k}={x}" for k, x in zip(
                    ("WARPS", "ROWS", "UNROLL", "TILE"), v)),
                cases, check, lambda a: matcher.gated_top2_kernel(*a))


def tune_schur():
    lam = torch.tensor(1e-3, device="cuda")
    bench = cs.bench_problem()
    cases = {"C8_P1024_O8": (bench, bench)}    # (as given, without pads)
    for label, case in cs.SCHUR_EXTRA.items():
        fields = cs.ba_case(**case, seed=1)
        cases[label] = (cs.to_problem(fields, "cuda"), cs.to_problem(
            cs.without_pad_indices(fields), "cuda"))

    def check(label, args):
        prob, plain = args
        cs.assert_schur_close(schur.schur_reduce_kernel(prob, lam, 0.01),
                              ba.schur_reduce(plain, lam, 0.01), label)

    return tune("schur", schur._lib, SCHUR_VARIANTS,
                lambda v: (f"-DGSLAM_SCHUR_THREADS={v[0]}",
                           f"-DGSLAM_SCHUR_GROUP={v[1]}"),
                cases, check,
                lambda a: schur.schur_reduce_kernel(a[0], lam, 0.01))


def time_matcher():
    out = {}
    for N, M in ((2048, 512), (333, 1000), (8192, 2048)):
        args = [torch.as_tensor(x, device="cuda")
                for x in cs.matcher_case(N, M, "ties", seed=5)]
        out[f"N{N}_M{M}"] = best_ms(
            lambda: matcher.hamming_top2_kernel(*args))
        print(f"  N={N} M={M} kernels (us):", kernel_split(
            lambda: matcher.hamming_top2_kernel(*args)), flush=True)
    print(f"matcher: {out}", flush=True)
    return out


BASE_FLAGS = build.NVCC_FLAGS
STEPS = {"b1": ("fast_nms_ms", tune_fast), "b4": ("gated_ms", tune_gated),
         "b5": ("schur_ms", tune_schur), "b3": ("matcher_ms", time_matcher)}


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_kernels: needs an NVIDIA card", file=sys.stderr)
        return 1
    chosen = sys.argv[1:] or list(STEPS)
    unknown = [c for c in chosen if c not in STEPS]
    if unknown:
        print(f"tune_kernels: unknown {unknown}; choose from "
              f"{list(STEPS)}", file=sys.stderr)
        return 2
    out = {"card": cs.card_name_and_power_limit()}
    for c in chosen:
        key, fn = STEPS[c]
        out[key] = fn()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
