"""Precompute HCQT features and pitch rolls for a corpus, on the port: the
equivalent of the reference's 01_precompute_features.ipynb and the
counterpart of ``examples/precompute_features.py``.

    python -m multipitch_architectures_tpu_torch.experiments.precompute \\
        --audio-dir /data/MusicNet/audio --csv-dir /data/MusicNet/csv \\
        --out-dir /data/MusicNet/features --chunk-frames 8192

For each ``<name>.wav`` (or ``.npy`` raw audio at --fs) in --audio-dir
with a matching ``<name>.csv|.txt`` note-event file (MusicNet/SWD
auto-detected; Bach10, PHENICX-Anechoic, ChoralSingingDataset and custom
formats via ``--schema``, io.NOTE_EVENT_SCHEMAS), writes:

    <out>/hcqt/<name>.npy   (216, T, 6)  float32   (reference layout)
    <out>/pitch/<name>.npy  (128, T)     float32

``NpyCorpus(<out>/hcqt, <out>/pitch)`` then loads what
``AudioCorpus.load`` computes. The HCQT runs on the card unless ``--cpu``
is given; without a card and without ``--cpu`` it stops with an error.
Its convolutions (the HCQT's half-band decimator) and matmuls run in
float32 with TF32 off (``set_f32_parity``), so that the features it
writes are the parity path's.
"""

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    from ..io import NOTE_EVENT_SCHEMAS

    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--audio-dir", required=True)
    ap.add_argument("--csv-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--fs", type=int, default=22050)
    ap.add_argument("--fs-hcqt-target", type=float, default=50)
    ap.add_argument("--bins-per-octave", type=int, default=36)
    ap.add_argument("--chunk-frames", type=int, default=None,
                    help="bounded-memory streamed HCQT for long"
                         " recordings (dsp.cqt_streamed)")
    ap.add_argument("--exact-frontend", action="store_true",
                    help="exact per-octave full-rate CQT (no multirate "
                    "approximation; slower, for gate-marginal serving)")
    ap.add_argument("--schema", default=None,
                    choices=sorted(NOTE_EVENT_SCHEMAS),
                    help="annotation schema preset (io.NOTE_EVENT_SCHEMAS);"
                         " default auto-detects MusicNet/SWD csv")
    ap.add_argument("--cpu", action="store_true",
                    help="run the HCQT on the CPU instead of the card")
    args = ap.parse_args(argv)

    from .. import resolve_device, set_f32_parity
    from .runner import annotation_path, audio_example

    set_f32_parity()          # float32 as the JAX package computes it
    device = resolve_device("cpu" if args.cpu else None)
    for sub in ("hcqt", "pitch"):
        os.makedirs(os.path.join(args.out_dir, sub), exist_ok=True)
    for fn in sorted(os.listdir(args.audio_dir)):
        name, ext = os.path.splitext(fn)
        if ext not in (".wav", ".npy"):
            continue
        inputs, targets = audio_example(
            os.path.join(args.audio_dir, fn),
            annotation_path(args.csv_dir, name), fs=args.fs,
            fs_hcqt_target=args.fs_hcqt_target,
            bins_per_octave=args.bins_per_octave,
            chunk_frames=args.chunk_frames, schema=args.schema,
            exact=args.exact_frontend, device=device)
        f_hcqt = np.ascontiguousarray(np.transpose(inputs, (2, 1, 0)))
        np.save(os.path.join(args.out_dir, "hcqt", name + ".npy"), f_hcqt)
        np.save(os.path.join(args.out_dir, "pitch", name + ".npy"),
                np.ascontiguousarray(targets.T))
        print(f"{name}: hcqt {f_hcqt.shape}, roll {targets.T.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
