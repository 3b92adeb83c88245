"""The reference's training step in plain PyTorch: the windowed training
set with its augmentation chain, binary cross-entropy and AdamW.

It draws every random value from the same seeds, in the same order and
shapes, as the training recipe prescribes (a device generator seeded per
epoch stream and batch index; dropout from the device's default
generator, seeded before each step), so given the same corpus, weights
and seed it follows the same steps. The augmentation is the reference's
(``libdl/data_loaders/hcqt_datasets.py``) in its published order:
random EQ, additive noise, log compression, tuning shift,
transposition; the EQ takes the first of 16 candidate filters that
stays non-negative.
"""

import numpy as np
import torch

EQ_OFFSETS = (-36, 0, 36, 57, 72, 83)
EQ_CANDIDATES = 16
EDGE_NOISE_STD = 1e-4
BCE_EPS = 1e-7
TRAIN, TRAIN_DATA = 0, 2          # the recipe's seed streams of an epoch


def fold_in(*values):
    """A 63-bit seed that is a pure function of ``values``."""
    state = np.random.SeedSequence([int(v) for v in values]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


class TrainingSet:
    """Files concatenated ``context`` zero frames apart, on ``device``;
    window centres every ``stride`` frames of each file."""

    def __init__(self, files, context, stride, device):
        xs, ys, centres, offset = [], [], [], 0
        for x, y in files:
            n = (x.shape[1] - context) // stride
            centres.append(offset + context // 2
                           + stride * np.arange(n, dtype=np.int64))
            xs += [x, np.zeros((x.shape[0], context, x.shape[2]), np.float32)]
            ys += [y, np.zeros((context, y.shape[1]), np.float32)]
            offset += x.shape[1] + context
        self.x = torch.as_tensor(np.concatenate(xs, axis=1), device=device)
        self.y = torch.as_tensor(np.concatenate(ys, axis=0), device=device)
        self.centres = torch.as_tensor(np.concatenate(centres), device=device)
        self.context = context

    def batches(self, seed, batch_size, aug, indices):
        """The (x, y) batches ``indices`` of the epoch seeded ``seed``."""
        dev = self.x.device

        def gen(*stream):
            return torch.Generator(device=dev).manual_seed(
                fold_in(seed, *stream))

        order = torch.randperm(len(self.centres), generator=gen(0),
                               device=dev)
        for i in indices:
            c = self.centres[order[i * batch_size:(i + 1) * batch_size]]
            idx = c[:, None] - self.context // 2 + torch.arange(
                self.context, device=dev)
            x = self.x[:, idx].transpose(0, 1)
            y = self.y[c][:, None, None, :]
            yield augment(gen(1, i), x, y, aug)


def take_bins(x, idx):
    view = (idx.shape[0],) + (1,) * (x.dim() - 2) + (idx.shape[1],)
    return torch.gather(x, -1, idx.view(view).expand(*x.shape[:-1],
                                                     idx.shape[1]))


def augment(gen, x, y, aug):
    """The chain on a batch (B, C, T, F), (B, 1, 1, bins)."""
    b, c, t, f = x.shape
    dev = x.device
    bins = torch.arange(f, device=dev)
    if aug.get("randomeq"):
        alphas = torch.randint(1, aug["randomeq"] + 1, (b, EQ_CANDIDATES),
                               generator=gen, device=dev)
        betas = torch.randint(0, f, (b, EQ_CANDIDATES), generator=gen,
                              device=dev)
    if aug.get("noisestd"):
        noise = aug["noisestd"] * torch.randn(x.shape, generator=gen,
                                              device=dev)
    if aug.get("tuning"):
        shift2 = torch.randint(-2, 3, (b,), generator=gen, device=dev)
        t_edge = (EDGE_NOISE_STD * torch.randn((b, c, t, 1), generator=gen,
                                               device=dev)).abs()
    k = aug.get("transposition")
    if k:
        transp = torch.randint(-k, k + 1, (b,), generator=gen, device=dev)
        edge = (EDGE_NOISE_STD * torch.randn((b, c, t, 3 * k), generator=gen,
                                             device=dev)).abs()
    if aug.get("randomeq"):
        offs = torch.tensor(EQ_OFFSETS[:c], device=dev)
        centres = betas[:, :, None, None] - offs[:, None]
        filt = 1.0 - 2e-6 * alphas[:, :, None, None] * (bins - centres) ** 2
        ok = filt.amin(dim=(2, 3)) >= 0
        chosen = filt[torch.arange(b, device=dev), ok.int().argmax(dim=1)]
        chosen = torch.where(ok.any(dim=1)[:, None, None], chosen,
                             torch.ones_like(chosen))
        x = x * chosen[:, :, None, :].to(x.dtype)
    if aug.get("noisestd"):
        x = (x + noise).abs()
    x = torch.log1p(aug["compression"] * x)
    if aug.get("tuning"):
        s = shift2[:, None]
        lo = (bins - torch.div(s + 1, 2, rounding_mode="floor")) % f
        hi = (bins - torch.div(s, 2, rounding_mode="floor")) % f
        shifted = (take_bins(x, lo) + take_bins(x, hi)) / 2
        rolled_in = ((bins == 0) & (s > 0)) | ((bins == f - 1) & (s < 0))
        x = torch.where(rolled_in[:, None, None, :], t_edge, shifted)
    if k:
        shift = 3 * transp[:, None]
        src = (bins - shift) % f
        wrap = torch.where(shift >= 0, bins < shift, bins >= f + shift)
        j = torch.where(shift >= 0, bins, bins - f - shift)
        noise_in = take_bins(edge, j.clamp(0, edge.shape[-1] - 1))
        x = torch.where(wrap[:, None, None, :], noise_in, take_bins(x, src))
        n = y.shape[-1]
        ybins = torch.arange(n, device=dev)
        ysrc = (ybins - transp[:, None]) % n
        ywrap = torch.where(transp[:, None] >= 0, ybins < transp[:, None],
                            ybins >= n + transp[:, None])
        y = take_bins(y, ysrc)
        if n != 12:
            y = y.masked_fill(ywrap[:, None, None, :], 0.0)
    return x, y


def bce(p, y):
    p = p.clamp(BCE_EPS, 1.0 - BCE_EPS)
    return -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p)).mean()


class AdamW:
    """AdamW by hand over ``params`` (name: tensor); its moments ``m``,
    ``v`` and step count ``t`` start at zero or from a given state."""

    def __init__(self, params, opt, m=None, v=None, t=0):
        self.params, self.opt, self.t = params, opt, t
        self.m = m or {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = v or {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self):
        opt, (b1, b2) = self.opt, self.opt["betas"]
        self.t += 1
        for k, p in self.params.items():
            g, m, v = p.grad, self.m[k], self.v[k]
            p.mul_(1.0 - opt["lr"] * opt["weight_decay"])
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / np.sqrt(1.0 - b2 ** self.t)).add_(
                opt["eps"])
            p.addcdiv_(m, denom, value=-opt["lr"] / (1.0 - b1 ** self.t))


def steps(model, batches, seeds, adamw, before=None):
    """One step of ``adamw`` (an :class:`AdamW` over ``model``'s
    parameters) per batch, dropout seeded from ``seeds``; ``before(n)``,
    if given, is called before step ``n`` (from 0). Returns (losses, each
    step's gradients by name)."""
    params = adamw.params
    losses, grads = [], []
    model.train()
    for n, ((x, y), seed) in enumerate(zip(batches, seeds)):
        if before is not None:
            before(n)
        torch.manual_seed(seed)
        for p in params.values():
            p.grad = None
        loss = bce(model(x), y)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad.clone() for k, p in params.items()})
        adamw.step()
    return losses, grads
