"""v2 plot (reference python/paddle/v2/plot/plot.py Ploter): collects
per-step metric points and renders via matplotlib when available,
otherwise prints — training scripts calling Ploter keep working in
headless machines."""

from __future__ import annotations

__all__ = ["Ploter"]


class Ploter:
    def __init__(self, *titles):
        self.titles = list(titles)
        self.data = {t: ([], []) for t in titles}

    def append(self, title, step, value):
        xs, ys = self.data[title]
        xs.append(step)
        ys.append(float(value))

    def plot(self, path=None):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            for t in self.titles:
                xs, ys = self.data[t]
                if ys:
                    print(f"[plot] {t}: step {xs[-1]} value {ys[-1]:.6f} "
                          f"({len(ys)} points)")
            return None
        fig, ax = plt.subplots()
        for t in self.titles:
            xs, ys = self.data[t]
            ax.plot(xs, ys, label=t)
        ax.legend()
        if path:
            fig.savefig(path)
        return fig

    def reset(self):
        for t in self.titles:
            self.data[t] = ([], [])
