"""Fine-vs-coarse violin plot (counterpart of ``mlmc_tpu/plot/violinplot.py``;
reference mlmc/plot/violinplot.py:28-69). ``seaborn`` and ``pandas`` are
imported by the functions that draw.
"""
import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mlmc_tpu_torch.plot.plots import _host  # noqa: E402


def fine_coarse_violinplot(dframe, file="violinplot.pdf"):
    """Split violins of fine vs coarse sample values per level.

    :param dframe: pandas DataFrame with columns 'samples', 'type'
        ('fine'|'coarse'), 'level' (label string)
    """
    import seaborn as sns

    fig, ax = plt.subplots(figsize=(12, 8))
    sns.violinplot(data=dframe, x="level", y="samples", hue="type",
                   split=True, inner="quart", ax=ax)
    ax.set_xlabel("levels")
    ax.set_ylabel("samples")
    if file:
        fig.savefig(file)
        plt.close(fig)
    else:
        fig.show()
    return ax


class ViolinPlotter:
    """Stateful wrapper accumulating per-level data (reference violinplot.py)."""

    def __init__(self):
        self._frames = []

    def add_level(self, level_label, fine_samples, coarse_samples=None):
        import pandas as pd

        self._frames.append(pd.DataFrame(
            {"samples": _host(fine_samples), "type": "fine",
             "level": level_label}))
        if coarse_samples is not None:
            self._frames.append(pd.DataFrame(
                {"samples": _host(coarse_samples), "type": "coarse",
                 "level": level_label}))

    def show(self, file="violinplot.pdf"):
        import pandas as pd

        return fine_coarse_violinplot(pd.concat(self._frames, axis=0),
                                      file=file)


def violinplot(data, file="violinplot.pdf"):
    """Plain violin plot of a 1-D sample set (reference violinplot.py API)."""
    import seaborn as sns

    fig, ax = plt.subplots(figsize=(10, 7))
    sns.violinplot(y=_host(data).ravel(), inner="quart", ax=ax)
    if file:
        fig.savefig(file)
        plt.close(fig)
    return ax
