"""Time hand-written kernels of gslam_tpu_torch over their tuning
constants on one NVIDIA card.

    python3 scripts/tune_kernels.py [b1] [b4] [b5] [b6] [b2] [b7] [b3]

(all seven when none is named).  A source takes its tuning constants as
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
  O = 8, at C = 32 and at the loop run's C = 4, P = 384;
- ``csrc/schur.cu`` (B6): ``GSLAM_COST_THREADS`` per block,
  ``GSLAM_COST_POINTS`` points per block and ``GSLAM_COST_CLUSTER``
  blocks per cluster at most; timed at B5's three shapes;
- ``csrc/brief.cu`` (B2): ``GSLAM_BRIEF_WARPS`` per block,
  ``GSLAM_BRIEF_SPLIT`` warps per keypoint and ``GSLAM_BRIEF_KPW``
  keypoints per warp; timed on ``track_forward``'s example image
  (480 x 640) at K = 512 and at the loop run's K = 384;
- ``csrc/vocab.cu`` (B7): ``GSLAM_VOCAB_DPB`` descriptors (warps) per
  block and ``GSLAM_VOCAB_TOP_ROWS``, the most table rows a warp holds
  (the whole levels that fit are read before the descent); timed at
  ``chip_smoke.vocab_cases``' shapes (N = 384 and 512 at k = 6, L = 2,
  N = 512 at k = 8, L = 4, N = 384 at k = 10, L = 6).

Every variant is built into its own library (one ``nvcc`` each, all
started together; their register and shared-memory lines are printed),
checked against the plain version (B1, B2, B4 and B7 bit for bit, B5
within ``chip_smoke.assert_schur_close``, B6 within rtol 1e-5 and bit
for bit against the default build), then timed by CUDA-graph replay
(``chip_smoke.graph_ms``, the better of two).  The first variant of each
list is the source's default; its time is split by kernel name with
torch.profiler.  B6, B2 and B7 are one launch each, so their default is
split by phase instead: builds with ``GSLAM_COST_PHASE``,
``GSLAM_BRIEF_PHASE`` or ``GSLAM_VOCAB_PHASE`` set below its default
stop after an earlier phase (the source's header says which), and the
differences of their times are the phases' shares.  B3 is timed as
built.  The last line is one JSON object with the card's name and power
limit.
"""

import contextlib
import functools
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gslam_tpu_torch.models.graft import example_image  # noqa: E402
from gslam_tpu_torch.ops import frontend, vocab  # noqa: E402
from gslam_tpu_torch.ops.cuda import (  # noqa: E402
    brief, build, fastnms, matcher, schur,
)
from gslam_tpu_torch.ops.cuda import vocab as vocab_k  # noqa: E402
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
# B6 (threads per block, points per block, most blocks per cluster)
COST_VARIANTS = [(512, 64, 16), (1024, 128, 8), (1024, 128, 16),
                 (256, 32, 16), (512, 64, 8), (256, 64, 16), (256, 32, 8)]
COST_PHASES = (0, 1, 2)         # the default is 3
# B2 (warps per block, warps per keypoint, keypoints per warp)
BRIEF_VARIANTS = [(16, 8, 1), (8, 8, 1), (32, 8, 1), (16, 4, 1),
                  (8, 4, 1), (4, 4, 1), (8, 2, 1), (4, 1, 1), (2, 1, 1),
                  (16, 8, 2)]
BRIEF_PHASES = (0, 1)           # the default is 2
BRIEF_KS = (512, 384)
# B7 descriptors (warps) per block, table rows held
VOCAB_VARIANTS = [(4, 64), (4, 128), (4, 32), (4, 0), (2, 64), (8, 64)]
VOCAB_PHASES = (0, 1, 2, 3, 4)  # the default runs every level
VOCAB_CASES = ("loop", "slab", "big", "deep")


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


@contextlib.contextmanager
def variant(lib, flags):
    """Within the block, the wrapper module ``lib[0]`` loads its library
    through its loader ``lib[1]`` built with ``flags`` added."""
    module, loader = lib
    default = getattr(module, loader)
    setattr(module, loader, functools.partial(default, flags))
    try:
        yield
    finally:
        setattr(module, loader, default)


def best_ms(fn):
    return min(cs.graph_ms(fn) for _ in range(2))


def tune(name, lib, variants, to_flags, cases, check, call):
    """Each variant of ``name`` (its wrapper's ``lib``, as ``variant``
    takes it): checked on every case, then timed; the first (default)
    variant split by kernel name."""
    flags = [to_flags(v) for v in variants]
    build_variants(name, flags)
    out = {}
    for v, f in zip(variants, flags):
        row = {}
        with variant(lib, f):
            for label, args in cases.items():
                check(label, args)
                row[label] = best_ms(lambda: call(args))
                if v == variants[0]:
                    print(f"  {label} kernels (us):",
                          kernel_split(lambda: call(args)), flush=True)
        out["_".join(map(str, v))] = row
        print(f"{name} {v}: {row}", flush=True)
    return out


def ba_cases():
    """B5's and B6's cases: (problem as given, without pads) on the
    local-BA problem and chip_smoke.SCHUR_EXTRA's."""
    local = cs.bench.ba_problem(torch.device("cuda"))
    cases = {"C8_P1024_O8": (local, local)}
    for label, case in cs.SCHUR_EXTRA.items():
        fields = cs.ba_case(**case, seed=1)
        cases[label] = (cs.to_problem(fields, "cuda"), cs.to_problem(
            cs.without_pad_indices(fields), "cuda"))
    return cases


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

    return tune("fastnms", (fastnms, "_lib"), FAST_VARIANTS,
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

    return tune("gated", (matcher, "_gated_lib"), GATED_VARIANTS,
                lambda v: tuple(f"-DGSLAM_GATED_{k}={x}" for k, x in zip(
                    ("WARPS", "ROWS", "UNROLL", "TILE"), v)),
                cases, check, lambda a: matcher.gated_top2_kernel(*a))


def tune_schur():
    lam = torch.tensor(1e-3, device="cuda")
    cases = ba_cases()

    def check(label, args):
        prob, plain = args
        cs.assert_schur_close(schur.schur_reduce_kernel(prob, lam, 0.01),
                              ba.schur_reduce(plain, lam, 0.01), label)

    return tune("schur", (schur, "_lib"), SCHUR_VARIANTS,
                lambda v: (f"-DGSLAM_SCHUR_THREADS={v[0]}",
                           f"-DGSLAM_SCHUR_GROUP={v[1]}"),
                cases, check,
                lambda a: schur.schur_reduce_kernel(a[0], lam, 0.01))


def phase_split(name, lib, macro, phases, cases, call):
    """The default build of ``name`` stopped after each earlier phase
    (``-D{macro}=phase``): device ms per case, beside the default's."""
    flags = [(f"-D{macro}={p}",) for p in phases]
    build_variants(name, flags)
    out = {}
    for p, f in zip(phases, flags):
        with variant(lib, f):
            out[f"phase_{p}"] = {label: best_ms(lambda: call(args))
                                 for label, args in cases.items()}
    out["default"] = {label: best_ms(lambda: call(args))
                      for label, args in cases.items()}
    print(f"{name} by phase (ms): {out}", flush=True)
    return out


def tune_cost():
    cases = ba_cases()
    first = {}

    def check(label, args):
        prob, plain = args
        got = schur.ba_cost_kernel(prob, 0.01)
        torch.testing.assert_close(got, ba.ba_cost(plain, 0.01), rtol=1e-5,
                                   atol=0.0, msg=f"B6 variant ({label})")
        if not torch.equal(first.setdefault(label, got), got):
            raise AssertionError(f"B6 variant: other bits than the "
                                 f"default build ({label})")

    call = lambda a: schur.ba_cost_kernel(a[0], 0.01)   # noqa: E731
    out = tune("schur", (schur, "_lib"), COST_VARIANTS,
               lambda v: tuple(f"-DGSLAM_COST_{k}={x}" for k, x in zip(
                   ("THREADS", "POINTS", "CLUSTER"), v)), cases, check, call)
    out["phases"] = phase_split("schur", (schur, "_lib"),
                                "GSLAM_COST_PHASE",
                                COST_PHASES, cases, call)
    return out


def tune_brief():
    img = torch.as_tensor(example_image(cs.H, cs.W)[0], device="cuda")
    blur, uv, ca, sa, _ = cs.brief_inputs(img, max(BRIEF_KS))
    cases = {f"K{k}": (blur, uv[:k], ca[:k], sa[:k]) for k in BRIEF_KS}

    def check(label, args):
        if not torch.equal(brief.brief(*args),
                           frontend.brief_from_rotation(*args)):
            raise AssertionError(f"B2 variant disagrees ({label})")

    call = lambda a: brief.brief(*a)                     # noqa: E731
    out = tune("brief", (brief, "_lib"), BRIEF_VARIANTS,
               lambda v: tuple(f"-DGSLAM_BRIEF_{k}={x}" for k, x in zip(
                   ("WARPS", "SPLIT", "KPW"), v)), cases, check, call)
    out["phases"] = phase_split("brief", (brief, "_lib"),
                                "GSLAM_BRIEF_PHASE", BRIEF_PHASES, cases,
                                call)
    return out


def tune_vocab():
    all_cases = cs.vocab_cases()
    cases = {}
    for i, label in enumerate(VOCAB_CASES):
        voc, N, p_inv = all_cases[label]
        cases[f"{label}_N{N}_k{voc.k}_L{voc.L}"] = (
            voc, *cs.descent_case(voc, N, 20 + i, p_inv))

    def check(label, args):
        voc, d, v = args
        if not torch.equal(
                vocab_k.transform_words_kernel(voc.node_desc, d, v, voc.k,
                                               voc.L),
                vocab._transform_words(voc.node_desc, d, v, voc.k, voc.L)):
            raise AssertionError(f"B7 variant disagrees ({label})")

    def call(args):
        voc, d, v = args
        return vocab_k.transform_words_kernel(voc.node_desc, d, v, voc.k,
                                              voc.L)

    out = tune("vocab", (vocab_k, "_lib"), VOCAB_VARIANTS,
               lambda v: (f"-DGSLAM_VOCAB_DPB={v[0]}",
                          f"-DGSLAM_VOCAB_TOP_ROWS={v[1]}"),
               cases, check, call)
    out["phases"] = phase_split("vocab", (vocab_k, "_lib"),
                                "GSLAM_VOCAB_PHASE", VOCAB_PHASES, cases,
                                call)
    return out


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


STEPS = {"b1": ("fast_nms_ms", tune_fast), "b4": ("gated_ms", tune_gated),
         "b5": ("schur_ms", tune_schur), "b6": ("cost_ms", tune_cost),
         "b2": ("brief_ms", tune_brief), "b7": ("vocab_ms", tune_vocab),
         "b3": ("matcher_ms", time_matcher)}


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
