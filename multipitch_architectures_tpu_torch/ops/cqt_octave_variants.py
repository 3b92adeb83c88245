"""Times design variants of the CQT octave kernel on the card, on the
serving HCQT's work list of 21 octaves at 5069 frames (the bench's
117.7-s span) and at 431 (a 10-s request).

    python3 -m multipitch_architectures_tpu_torch.ops.cqt_octave_variants \
        [VARIANT ...]

Each variant is ``csrc/cqt_octave.cu`` with a few lines replaced (the
``VARIANTS`` table: the designs tried and dropped, and diagnostic cuts),
built and run through the same wrapper by the shared harness
``_variants``; the arguments pick variants (all by default). Every
variant that computes the transform is held to rel-to-peak 1e-5 of the
plain version in each octave's columns, and the run exits non-zero if one
is not; the diagnostic variants (``no_*``, ``plain_tf32``) are only timed,
their error printed. Times are CUDA-event means of 20 launches after 3
warm-ups, the variants in turns at each size. Needs one CUDA card.
"""

import sys

import numpy as np
import torch

from . import _variants
from . import cqt_octave as co

FRAMES = (5069, 431)
BPO = 36
# (n_fft, octaves) of the serving HCQT's bases 0.5, 3 and 5
BASES = ((512, 9), (512, 6), (256, 6))
TOL = 1e-5

_MMA = ("      wgmma_tf32<N>(acc, lo[s], b_hi, s > 0);\n"
        "      wgmma_tf32<N>(acc, hi[s], b_lo, 1);\n"
        "      wgmma_tf32<N>(acc, hi[s], b_hi, 1);\n")
_KC_64 = ("constexpr int KC = 32;", "constexpr int KC = 64;")
# (old text, new text) replacements of csrc/cqt_octave.cu
VARIANTS = {
    "final": [],
    # the dropped designs
    "tile_128": [("constexpr int TILE = 64;", "constexpr int TILE = 128;")],
    "stages_3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "stages_6": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "kc_64_stages_2": [_KC_64, ("constexpr int STAGES = 4;",
                                "constexpr int STAGES = 2;")],
    "kc_64_stages_3": [_KC_64, ("constexpr int STAGES = 4;",
                                "constexpr int STAGES = 3;")],
    # one accumulator over all of K: no chunk sums on CUDA cores
    "one_accumulator": [
        ("wgmma_tf32<N>(acc, lo[s], b_hi, s > 0);",
         "wgmma_tf32<N>(acc, lo[s], b_hi, kt > 0 || s > 0);"),
        ("      total[i] = __fadd_rn(total[i], acc[i]);",
         "      total[i] = acc[i];")],
    # one row loader: 4-byte copies at every hop past CONTIG_MAX_HOP, in
    # place of 16-byte copies where hop % 4 == 0 and y is 16-byte aligned
    "rows_4byte": [("const bool vec = !contig && hop % 4 == 0 &&",
                    "const bool vec = !contig && false &&")],
    "hi_hi_first": [(_MMA, "      wgmma_tf32<N>(acc, hi[s], b_hi, s > 0);\n"
                           "      wgmma_tf32<N>(acc, lo[s], b_hi, 1);\n"
                           "      wgmma_tf32<N>(acc, hi[s], b_lo, 1);\n")],
    # diagnostic cuts: one TF32 product (plain TF32), no wgmmas, no copies
    # inside the loop
    "plain_tf32": [(_MMA, "      wgmma_tf32<N>(acc, hi[s], b_hi, s > 0);\n")],
    "no_mma": [(_MMA, "")],
    "no_loads": [("      load(kt + STAGES - 1, smem + (kt + STAGES - 1) % "
                  "STAGES * STAGE_BYTES);\n", "")],
}
DIAGNOSTIC = {"plain_tf32", "no_mma", "no_loads"}


def variant_kc(name):
    return 64 if _KC_64 in VARIANTS[name] else co.KC


def work_list(dev, n_frames, kcs, seed=0):
    """The serving HCQT's 21 octaves at ``n_frames``: random signals,
    banks and scales, three outputs laid out as ``hcqt`` lays them.
    Returns ({kc: octaves with the bank in that K chunk}, the plain
    version's outputs, one per octave's columns)."""
    rng = np.random.RandomState(seed)
    lists = {kc: [] for kc in kcs}
    want = []
    for n_fft, n in BASES:
        kr = (rng.randn(n_fft, 2 * BPO) * 0.01).astype(np.float32)
        kr_t = torch.as_tensor(kr, device=dev)
        shape = (n_fft // co.KC, 2, co.KC // 4, co.kernel_width(BPO), 4)
        banks = {kc: torch.as_tensor(co.bank_for_kernel(kr, kc),
                                     device=dev).reshape(shape)
                 for kc in kcs}
        out = torch.empty((n_frames, n * BPO), device=dev)
        for k in range(n):
            hop = 512 >> k
            y = torch.as_tensor(rng.uniform(-1, 1, (n_frames - 1) * hop
                                            + n_fft), dtype=torch.float32,
                                device=dev)
            scale = torch.as_tensor(rng.uniform(1, 40, BPO),
                                    dtype=torch.float32, device=dev)
            kw = dict(hop=hop, n_fft=n_fft, n_frames=n_frames,
                      col=(n - 1 - k) * BPO)
            for kc in kcs:
                lists[kc].append(co.Octave(y, kr_t, banks[kc], scale, out,
                                           **kw))
            want.append(co.cqt_octave_reference(
                y, kr_t, hop=hop, n_fft=n_fft, bpo=BPO,
                n_frames=n_frames) * scale)
    return lists, want


def main(names):
    libs = _variants.build(co, "cqt_octave", VARIANTS, names)
    dev = torch.device("cuda", 0)
    wrong = set()
    print("| frames | " + " | ".join(names) + " |")
    for n_frames in FRAMES:
        lists, want = work_list(dev, n_frames, {variant_kc(n) for n in names})
        cells = []
        for name in names:
            work = lists[variant_kc(name)]
            with _variants.using(co, libs[name]):
                launch = co.cqt_octaves_launcher(work, bpo=BPO)
            for o in work:
                o.out.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            rel = max(float((o.out[:, o.col:o.col + BPO] - w).abs().max()
                            / w.abs().max()) for o, w in zip(work, want))
            ms = _variants.cuda_ms(launch, reps=20, warmup=3)
            ok = rel < TOL          # NaN too: a column left unwritten
            if not ok and name not in DIAGNOSTIC:
                wrong.add(name)
            cells.append(f"{ms:.4f} ms, rel {rel:.2e}"
                         + ("" if ok or name in DIAGNOSTIC else " WRONG"))
        print(f"| {n_frames} | " + " | ".join(cells) + " |")
    if wrong:
        print(f"outside rel-to-peak {TOL:g} of the plain version: "
              f"{sorted(wrong)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
