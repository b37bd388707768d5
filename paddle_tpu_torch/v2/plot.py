"""paddle.v2.plot (``paddle_tpu/v2/plot.py``; reference
python/paddle/v2/plot/plot.py): the Ploter notebook helper, named curves
appended a step and redrawn on plot().  DISABLE_PLOT=True turns plotting
into a cheap print (the reference used the same environment switch for
headless test conversion)."""

import os

__all__ = ["Ploter", "PlotData"]


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    def __init__(self, *args):
        self.__args__ = args
        self.__plot_data__ = {title: PlotData() for title in args}

    def __plot_is_disabled__(self):
        return os.environ.get("DISABLE_PLOT") == "True"

    def append(self, title, step, value):
        self.__plot_data__[title].append(step, float(value))

    def plot(self, path=None):
        if self.__plot_is_disabled__():
            for title, data in self.__plot_data__.items():
                if data.step:
                    print(f"{title}: step {data.step[-1]} "
                          f"value {data.value[-1]:.6g}")
            return
        import matplotlib
        if path:   # headless save
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        titles = []
        for title, data in self.__plot_data__.items():
            if data.step:
                plt.plot(data.step, data.value)
                titles.append(title)
        plt.legend(titles, loc="upper left")
        if path:
            plt.savefig(path)
            plt.close()
        else:     # notebook flow: clear + draw
            try:
                from IPython import display
                display.clear_output(wait=True)
            except Exception:
                pass
            plt.pause(0.001)

    def reset(self):
        for data in self.__plot_data__.values():
            data.reset()
