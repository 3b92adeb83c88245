"""Times design variants of the int8 GEMM on the card, at the 21
quantized conv shapes of exp180e at batch 250 and at the 4096³ probe.

    python3 -m multipitch_architectures_tpu_torch.ops.int8_gemm_variants \
        [VARIANT ...]

Each variant is ``csrc/int8_gemm.cu`` with a few lines replaced (the
``VARIANTS`` table: the designs tried and dropped, and diagnostic cuts),
built and run through the same wrappers by the shared harness
``_variants``; the arguments pick variants (all by default). Every variant that computes the product is held
bit-equal to the plain version at batches 23 and 250 (the probe at its
one shape), and the run exits non-zero if one is not; the diagnostic
variants (``no_*``) compute garbage and are only timed. Times are
CUDA-event means of 5 launches after one warm-up, the variants in turns
at each shape. Needs one CUDA card.
"""

import functools
import sys

import torch
import torch.nn.functional as F

from . import _variants
from . import int8_gemm

BATCH, PROBE = 250, 4096

_STAGES = ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")
_IN_FLIGHT = [("  constexpr int LOOKAHEAD = STAGES - 1;",
               "  constexpr int LOOKAHEAD = STAGES - 2;"),
              ("    cp_async_commit();\n    wgmma_wait<0>();\n  }\n",
               "    cp_async_commit();\n    wgmma_wait<1>();\n  }\n"
               "  wgmma_wait<0>();\n")]
_NO_LOADS = ("      ld.load(smem + (kt + LOOKAHEAD) % STAGES * stage_bytes, "
             "kt + LOOKAHEAD);\n", "")
# (old text, new text) replacements of csrc/int8_gemm.cu
VARIANTS = {
    "final": [],
    # the dropped designs; pad_16 is the final source, called with the
    # operands' channels zero-padded to 16 (see PAD_16)
    "pad_16": [],
    "gather_only": [("g.kw <= 16 && g.n <= 32) {", "g.kw <= 16 && g.n < 0) {")],
    "4_stages": [_STAGES],
    "4_stages_1_block_at_128": [
        _STAGES, ("(TAPS ? BN <= 32 : BN <= 128) ? 2 : 1",
                  "(TAPS ? BN <= 32 : BN <= 64) ? 2 : 1")],
    "4_stages_wgmma_in_flight": [_STAGES] + _IN_FLIGHT,
    "l1_cached_copies": [("cp.async.cg.shared.global [%0], [%1], 16",
                          "cp.async.ca.shared.global [%0], [%1], 16")],
    "taps_2_segments": [("  static constexpr int SEGS = 4;\n"
                         "  static constexpr int SEGS_PER_BLOCK",
                         "  static constexpr int SEGS = 2;\n"
                         "  static constexpr int SEGS_PER_BLOCK")],
    "taps_to_cout_64": [(
        "      g.kw <= 16 && g.n <= 32) {\n"
        "    return run<32, 16, true>(x, b, y, g, dq, s);\n  }",
        "      g.kw <= 16 && g.n <= 64) {\n"
        "    if (g.n <= 32) return run<32, 16, true>(x, b, y, g, dq, s);\n"
        "    return run<64, 16, true>(x, b, y, g, dq, s);\n  }")],
    "bn_128_past_208": [("  return run<256, 16, false>(x, b, y, g, dq, s);",
                         "  return run<128, 16, false>(x, b, y, g, dq, s);")],
    # diagnostic cuts: what the loop costs without its copies, without
    # its wgmmas, and without copies, proxy fence and barrier
    "no_loads": [_NO_LOADS],
    "no_mma": [("      wgmma_s8<BN>(acc[0], sw128_desc(", "      if (0) "
                "wgmma_s8<BN>(acc[0], sw128_desc("),
               ("        wgmma_s8<BN>(acc[s],\n", "        if (0) "
                "wgmma_s8<BN>(acc[s],\n")],
    "no_loads_fence_barrier": [
        _NO_LOADS, ("    cp_async_wait<LOOKAHEAD - 1>();\n"
                    "    fence_proxy_async();\n    __syncthreads();\n",
                    "    cp_async_wait<LOOKAHEAD - 1>();\n")],
}


# variants whose operands the caller zero-pads to 16 channels, so that the
# 6-channel first conv takes the 16-byte copies and not the 8-byte ones
PAD_16 = {"pad_16"}


def pad_16(xq, wq):
    """``xq`` and ``wq`` with their channels zero-padded to a multiple of
    16."""
    return tuple(F.pad(t, (0, -t.shape[-1] % 16)) for t in (xq, wq))


def conv_shapes(dev):
    """[(name, conv, (C, H, W) of its input)] of exp180e's quantized
    convs, from one forward of a window with seeded random weights."""
    from ..eval import eligible_convs
    from ..experiments import load_experiment
    from ..models import init_parameters

    model = load_experiment("exp180e_musicnet_unet_insanelylarge_"
                            "doubleselfattn").build_model(
                                attn_mode="cross_batch:50")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval().to(dev)
    shapes = []
    handles = [conv.register_forward_pre_hook(
        lambda m, args, name=name: shapes.append(
            (name, m, tuple(args[0].shape[1:]))))
        for name, conv in eligible_convs(model)]
    with torch.no_grad():
        model(torch.zeros((1, 6, 75, 216), device=dev))
    for h in handles:
        h.remove()
    return shapes


def main(names):
    libs = _variants.build(int8_gemm, "int8_gemm", VARIANTS, names)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    wrong = set()

    def timed(name, fn, wants):
        """ms of ``fn()`` under variant ``name``, with "wrong" appended
        (and the variant marked so) unless each (call, want) gives want
        bit for bit."""
        with _variants.using(int8_gemm, libs[name]):
            ok = all(torch.equal(call(), want) for call, want in wants)
            ms = _variants.cuda_ms(fn, reps=5, warmup=1)
        if ok or name.startswith("no_"):
            return f"{ms:.3f}"
        wrong.add(name)
        return f"{ms:.3f} wrong"

    totals = dict.fromkeys(names, 0.0)
    print("| conv | " + " | ".join(names) + " |")
    for conv_name, conv, (c, h, w) in conv_shapes(dev):
        (kh, kw), cout = conv.kernel_size, conv.out_channels
        args = (conv.stride, conv.padding)
        wq = rand8(cout, kh, kw, c)
        dq = (torch.rand(cout, generator=gen, device=dev) * 1e-3,
              torch.rand((), generator=gen, device=dev) + 0.5,
              torch.randn(cout, generator=gen, device=dev))
        xqs = [rand8(batch, h, w, c) for batch in (23, BATCH)]
        wants = [int8_gemm.int8_conv2d_dequant_reference(xq, wq, *args, *dq)
                 for xq in xqs]
        row = []
        for v in names:
            calls = [
                functools.partial(int8_gemm.int8_conv2d_dequant,
                                  *(pad_16(xq, wq) if v in PAD_16
                                    else (xq, wq)), *args, *dq)
                for xq in xqs]
            row.append(timed(v, calls[-1], list(zip(calls, wants))))
        for v, t in zip(names, row):
            totals[v] += float(t.split()[0])
        print(f"| {conv_name} | " + " | ".join(row) + " |")
        del xqs, wants, calls
    print("| 21 convs | " + " | ".join(f"{totals[v]:.2f}" for v in names)
          + " |")
    a, b = rand8(PROBE, PROBE), rand8(PROBE, PROBE)
    want = [(lambda: int8_gemm.int8_mm(a, b),
             int8_gemm.int8_mm_reference(a, b))]
    print(f"| probe {PROBE}^3 | " + " | ".join(
        timed(v, lambda: int8_gemm.int8_mm(a, b), want) for v in names)
        + " |")
    if wrong:
        raise AssertionError(f"variants {sorted(wrong)} differ from the "
                             f"plain version")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
