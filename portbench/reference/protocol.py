"""The reference's framewise test protocol in plain PyTorch: the log
compressed HCQT padded by (context//2, context//2 + 1) zero frames, one
stride-1 window per frame, run through the model in the test loader's
batches of ``batch`` consecutive windows, the last one short."""

import torch
import torch.nn.functional as F

from . import frontend


@torch.no_grad()
def predict(model, hcqt, compression, context=75, batch=50):
    """(T, bins) predictions of ``model`` (eval mode) for the raw HCQT
    (harmonics, T, bins)."""
    x = torch.log1p(compression * hcqt)
    t = x.shape[1]
    half = context // 2
    xp = F.pad(x, (0, 0, half, half + 1))
    offsets = torch.arange(context, device=x.device)
    outs = []
    for start in range(0, t, batch):
        idx = torch.arange(start, min(t, start + batch),
                           device=x.device)[:, None] + offsets
        windows = xp[:, idx].transpose(0, 1)              # (B, C, ctx, F)
        outs.append(model(windows).reshape(idx.shape[0], -1))
    return torch.cat(outs)


def transcribe(model, audio, fe, device, batch):
    """(raw HCQT, predictions) of one recording, from the audio."""
    h = frontend.hcqt(audio, fe, device)
    return h, predict(model, h, fe["compression"], fe["context"], batch)
