"""Plotting: the one libfmp plotting function that the reference's
notebooks use (``libfmp.b.plot_matrix``). Counterpart of the JAX
package's ``utils/plot.py``; matplotlib is imported only when a plot is
drawn."""

from typing import Optional, Tuple


def plot_matrix(x, fs: float = 1.0, fs_f: float = 1.0,
                title: str = "", xlabel: str = "Time (seconds)",
                ylabel: str = "Frequency (bins)",
                figsize: Tuple[float, float] = (8, 3),
                cmap: str = "gray_r", clim: Optional[Tuple] = None,
                ax=None):
    """Display a (bins, frames) feature matrix like libfmp.b.plot_matrix:
    origin lower-left, time axis in seconds at frame rate ``fs``. ``x``
    may be a tensor on any device."""
    import matplotlib.pyplot as plt
    import numpy as np

    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if ax is None:
        _, ax = plt.subplots(figsize=figsize)
    extent = [0, x.shape[1] / fs, 0, x.shape[0] / fs_f]
    im = ax.imshow(x, origin="lower", aspect="auto", cmap=cmap,
                   extent=extent)
    if clim is not None:
        im.set_clim(clim)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    plt.colorbar(im, ax=ax)
    return ax
