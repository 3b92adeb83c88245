"""Run one of the reference's 111 experiments by name, on the port.

Examples:
    # list experiments
    python -m multipitch_architectures_tpu_torch.experiments.run --list
    # smoke-run the SAUnet:L experiment on synthetic data on the CPU
    python -m multipitch_architectures_tpu_torch.experiments.run \\
        --config exp180d_musicnet_unet_extremelylarge_doubleselfattn \\
        --smoke --cpu
    # full run on precomputed features, on the card
    python -m multipitch_architectures_tpu_torch.experiments.run \\
        --config exp180d_musicnet_unet_extremelylarge_doubleselfattn \\
        --data-dir /data/MusicNet/hcqt --annot-dir /data/MusicNet/pitch \\
        --out-dir runs/
    # full run from audio and note-event files (features computed on the
    # card at load time; --chunk-frames streams long recordings)
    python -m multipitch_architectures_tpu_torch.experiments.run \\
        --config exp180d_musicnet_unet_extremelylarge_doubleselfattn \\
        --audio-dir /data/MusicNet/audio --csv-dir /data/MusicNet/csv \\
        --chunk-frames 8192 --out-dir runs/
    # the same, with a torch.profiler Chrome trace of the run in prof/
    python -m multipitch_architectures_tpu_torch.experiments.run \\
        --config exp180d_musicnet_unet_extremelylarge_doubleselfattn \\
        --data-dir /data/MusicNet/hcqt --annot-dir /data/MusicNet/pitch \\
        --out-dir runs/ --profile prof/

Runs on the card unless ``--cpu`` is given; without a card and without
``--cpu`` it stops with an error. On a host with several cards it trains
data-parallel over all of them, as the JAX package's ``run_experiment``
does (``Trainer``'s default device set: each batch padded to a multiple
of the card count, BatchNorm over the global batch); the test phase runs
on the first card. Its convolutions and matmuls run in float32 with
TF32 off (``set_f32_parity``), as the parity path computes them.
"""

import argparse
import contextlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", help="experiment name from the registry")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--data-dir")
    ap.add_argument("--annot-dir")
    ap.add_argument("--audio-dir",
                    help="train directly from .wav/.npy audio (with"
                         " --csv-dir annotations): features computed"
                         " on the device at load time, no precompute step")
    ap.add_argument("--csv-dir")
    ap.add_argument("--chunk-frames", type=int, default=None,
                    help="streamed bounded-memory HCQT for --audio-dir")
    ap.add_argument("--schema", default=None,
                    help="annotation schema preset for --csv-dir"
                         " (io.NOTE_EVENT_SCHEMAS: musicnet, swd, bach10,"
                         " phenicx, csd); default auto-detects"
                         " MusicNet/SWD csv")
    ap.add_argument("--out-dir", default="runs")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic data + 1 epoch + shrunken model")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--fix-val-split", action="store_true",
                    help="repair the reference's merged val prefixes")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore the experiment checkpoint and continue"
                         " training from the next epoch")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the run"
                         " to DIR/trace.json (Perfetto- or"
                         " chrome://tracing-loadable)")
    args = ap.parse_args(argv)
    # checked before any file is read or computed
    from ..io import NOTE_EVENT_SCHEMAS

    if args.schema is not None and args.schema not in NOTE_EVENT_SCHEMAS:
        ap.error(f"--schema {args.schema!r} unknown; choose from "
                 f"{sorted(NOTE_EVENT_SCHEMAS)}")
    if args.audio_dir and not args.csv_dir:
        ap.error("--csv-dir is required with --audio-dir")

    from .. import set_f32_parity
    from ..utils import trace
    from . import (AudioCorpus, NpyCorpus, SyntheticCorpus,
                   available_experiments, load_experiment, run_experiment,
                   shrink_for_smoke)

    set_f32_parity()          # float32 as the JAX package computes it

    if args.list:
        for name in available_experiments():
            print(name)
        return 0
    if not args.config:
        ap.error("--config is required (or --list)")

    cfg = load_experiment(args.config, fix_val_split=args.fix_val_split)
    device = "cpu" if args.cpu else None
    epochs = args.epochs
    if args.smoke:
        cfg = shrink_for_smoke(cfg)
        corpus = SyntheticCorpus(cfg, frames=300)
        epochs = args.epochs or 1
    elif args.audio_dir:
        corpus = AudioCorpus(args.audio_dir, args.csv_dir,
                             chunk_frames=args.chunk_frames,
                             annotation_schema=args.schema, device=device)
    else:
        if not (args.data_dir and args.annot_dir):
            ap.error("--data-dir and --annot-dir (or --audio-dir and "
                     "--csv-dir) are required without --smoke")
        corpus = NpyCorpus(args.data_dir, args.annot_dir)
    with (trace(args.profile) if args.profile
          else contextlib.nullcontext()):
        results = run_experiment(cfg, corpus, args.out_dir,
                                 max_epochs_override=epochs,
                                 resume=args.resume, device=device)
    if results.get("subsets"):
        fw = results["subsets"][0]["framewise_mean"]
        print(f"Framewise f_measure: {fw.get('f_measure')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
