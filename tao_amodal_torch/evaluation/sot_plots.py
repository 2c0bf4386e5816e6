"""SOT benchmark figures: success and precision curves, the EAO radar.

Port of :mod:`tao_amodal_tpu.evaluation.sot_plots` (the reference's
``pysot/toolkit/visualization/draw_success_precision.py:1-114`` and
``draw_eao.py:1-49``): figures render through matplotlib's Agg backend
straight to files.  matplotlib is imported inside the functions that draw;
a machine without it raises its ``ImportError`` there.
"""

from __future__ import annotations

import numpy as np

# Reference draw_utils.py palette (the established benchmark-figure
# color order, kept so multi-tracker figures read the same).
COLOR = ((1, 0, 0), (0, 1, 0), (1, 0, 1), (1, 1, 0), (0, 162 / 255,
         232 / 255), (0.5, 0.5, 0.5), (0, 0, 1), (0, 1, 1),
         (136 / 255, 0, 21 / 255), (255 / 255, 127 / 255, 39 / 255),
         (0, 0, 0))
LINE_STYLE = ('-', '--', ':', '-', '--', ':', '-', '--', ':', '-', '-')
MARKER_STYLE = ('o', 'v', '<', '*', 'D', 'x', '.', 'x', '<', '.', 'D')


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_success_precision(success_ret, name, videos=None, attr="ALL",
                           precision_ret=None, bold_name=None,
                           axis=(0, 1), out_prefix="plot"):
    """Success (and optional precision) plots of OPE.

    ``success_ret``/``precision_ret``: {tracker: {seq: curve}} as
    produced by :class:`..sot_benchmarks.OPEBenchmark`.  Writes
    ``<out_prefix>_success.png`` (+ ``_precision.png``) and returns the
    written paths.
    """
    plt = _plt()
    written = []

    def seq_curves(ret, tracker):
        return [v for k, v in ret[tracker].items()
                if videos is None or k in videos]

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.grid(True)
    thresholds = np.arange(0, 1.05, 0.05)
    scores = {t: float(np.mean(seq_curves(success_ret, t)))
              for t in success_ret}
    for idx, (tracker, auc) in enumerate(
            sorted(scores.items(), key=lambda kv: -kv[1])):
        label = f"[{auc:.3f}] {tracker}"
        curve = np.mean(seq_curves(success_ret, tracker), axis=0)
        lw = 3 if tracker == bold_name else 2
        plt.plot(thresholds, curve, color=COLOR[idx % len(COLOR)],
                 linestyle=LINE_STYLE[idx % len(LINE_STYLE)],
                 label=label, linewidth=lw)
    suffix = name if attr == "ALL" else attr
    ax.set_xlabel("Overlap threshold")
    ax.set_ylabel("Success rate")
    ax.set_title(f"Success plots of OPE on {suffix}")
    ax.set_xlim(0, 1)
    ax.set_ylim(*axis)
    ax.legend(loc="lower left", labelspacing=0.2)
    path = f"{out_prefix}_success.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    if precision_ret:
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.grid(True)
        thresholds = np.arange(0, 51, 1)
        p20 = {t: float(np.mean(seq_curves(precision_ret, t),
                                axis=0)[20])
               for t in precision_ret}
        for idx, (tracker, pre) in enumerate(
                sorted(p20.items(), key=lambda kv: -kv[1])):
            label = f"[{pre:.3f}] {tracker}"
            curve = np.mean(seq_curves(precision_ret, tracker), axis=0)
            lw = 3 if tracker == bold_name else 2
            plt.plot(thresholds, curve[:len(thresholds)],
                     color=COLOR[idx % len(COLOR)],
                     linestyle=LINE_STYLE[idx % len(LINE_STYLE)],
                     label=label, linewidth=lw)
        ax.set_xlabel("Location error threshold")
        ax.set_ylabel("Precision")
        ax.set_title(f"Precision plots of OPE on {suffix}")
        ax.set_xlim(0, 50)
        ax.set_ylim(*axis)
        ax.legend(loc="lower right", labelspacing=0.2)
        path = f"{out_prefix}_precision.png"
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def draw_eao(result, out_path="eao.png"):
    """EAO radar plot over attribute tags (reference ``draw_eao.py``):
    one polar axis per tag, trackers normalized by the per-tag max.

    ``result``: {tracker: {tag: eao}} from
    :class:`..sot_benchmarks.EAOBenchmark`.
    """
    plt = _plt()
    trackers = list(result)
    if not trackers:
        return None
    tags = list(result[trackers[0]])
    values = np.array([[result[t][tag] for tag in tags]
                       for t in trackers])           # [N, A]
    closed = np.concatenate([values, values[:, :1]], axis=1)
    angles = np.linspace(0, 2 * np.pi, len(tags) + 1, endpoint=True)
    max_v = np.maximum(closed.max(axis=0), 1e-12)
    min_v = closed.min(axis=0)

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="polar")
    for i, tracker in enumerate(trackers):
        plt.plot(angles, closed[i] / max_v, linestyle="-",
                 color=COLOR[i % len(COLOR)],
                 marker=MARKER_STYLE[i % len(MARKER_STYLE)],
                 label=tracker, linewidth=1.5, markersize=6)
    labels = [f"{tag}\n({lo:.3f},{hi:.3f})"
              for tag, lo, hi in zip(tags, min_v, max_v)]
    ax.set_thetagrids(angles[:-1] * 180 / np.pi, labels)
    ax.spines["polar"].set_visible(False)
    ax.legend(loc="upper center", bbox_to_anchor=(0.5, -0.07),
              frameon=False, ncol=min(len(trackers), 5))
    ax.set_ylim(0, 1.18)
    ax.set_yticks([])
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
