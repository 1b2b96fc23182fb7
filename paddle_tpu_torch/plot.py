"""Training-curve plotting helper (PyTorch port of ``paddle_tpu/plot.py``;
ref: python/paddle/v2/plot/plot.py — ``Ploter`` collecting per-step costs;
here it renders to an image file via headless matplotlib, degrading to CSV
export when matplotlib does not import, as on a machine without it)."""
from __future__ import annotations

from typing import Dict, List


class PlotData:
    def __init__(self):
        self.step: List[float] = []
        self.value: List[float] = []

    def append(self, step, value):
        self.step.append(float(step))
        self.value.append(float(value))

    def reset(self):
        self.step, self.value = [], []


class Ploter:
    """Collect one curve per title; ``plot(path)`` renders the curves to an
    image file with matplotlib when importable (headless Agg backend).
    Returns False — leaving the data available via ``data``/``save_csv`` —
    when matplotlib is missing or no output path is given."""

    def __init__(self, *titles: str):
        self.titles = list(titles)
        self.data: Dict[str, PlotData] = {t: PlotData() for t in titles}

    def append(self, title: str, step, value):
        self.data[title].append(step, value)

    def plot(self, path: str = None):
        if not path:
            return False
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return False
        plt.figure()
        for t in self.titles:
            d = self.data[t]
            plt.plot(d.step, d.value, label=t)
        plt.legend()
        plt.savefig(path)
        plt.close()
        return True

    def save_csv(self, path: str):
        with open(path, "w") as f:
            f.write("title,step,value\n")
            for t in self.titles:
                d = self.data[t]
                for s, v in zip(d.step, d.value):
                    f.write(f"{t},{s},{v}\n")

    def reset(self):
        for d in self.data.values():
            d.reset()
