#!/usr/bin/env python3
"""Paper-figure analysis over inference artifacts (port of
``tools/mosei_plot_results.py``; reference: notebooks/mosei_plot_results.ipynb,
cells 5-12, as a script).

From ``{split}_y_prob.npy``, ``{split}_y_true.npy``, ``{split}_beta_mean.npy``
and ``{split}_attentions.pt`` (``mosei_eval_infer --dump_beta --dump_attn``):

  * positive/negative score histograms with the threshold lines (cell 5);
  * the predicted-label correlation heatmap (cell 7);
  * per-class confusion matrices (cell 8);
  * the beta histogram: above 0.5 audio-dominant, below text-dominant
    (cells 9-10);
  * per sample, the encoder's last ``audio_queries_text`` map ("Cross-Modal
    Alignment") beside the decoder's last map ("Emotion Attribution"),
    padding cropped (cell 11);
  * the exact-match case study (cell 12), ``case_study.txt``.

matplotlib is imported in ``main``.

    python -m hriemo_torch.tools.mosei_plot_results --pred_dir preds --split val --ckpt best.pt
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.synthetic import MOSEI_EMO_COLS

EMO = [c.replace("emo_", "") for c in MOSEI_EMO_COLS]


def label_correlation(y_pred: np.ndarray) -> np.ndarray:
    """Correlation of the predicted labels; a class that never (or always)
    crosses its threshold has no correlation and keeps the identity row."""
    n = y_pred.shape[1]
    corr = np.eye(n)
    varying = np.where(y_pred.std(axis=0) > 0)[0]
    if len(varying) >= 2:
        corr[np.ix_(varying, varying)] = np.corrcoef(y_pred[:, varying].T)
    return corr


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..utils import metrics as M

    ap = argparse.ArgumentParser()
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--max_attn_samples", type=int, default=4)
    args = ap.parse_args(argv)

    pred_dir = Path(args.pred_dir)
    out = Path(args.out_dir or pred_dir / "figs_results")
    out.mkdir(parents=True, exist_ok=True)

    y_prob = np.load(pred_dir / f"{args.split}_y_prob.npy")
    y_true = M.binarize_truth(np.load(pred_dir / f"{args.split}_y_true.npy"))
    n_classes = y_true.shape[1]
    names = EMO[:n_classes]

    ths = np.full(n_classes, 0.5)
    if args.ckpt:
        from ..utils.checkpoint import load_torch_checkpoint

        t = load_torch_checkpoint(args.ckpt).get("val_calibrated_thresholds")
        if t is not None:
            ths = np.asarray(t)
    y_pred = M.apply_thresholds(y_prob, ths)

    # score histograms with threshold lines (cell 5)
    fig, axes = plt.subplots(2, 3, figsize=(13, 7))
    for c, ax in enumerate(axes.ravel()[:n_classes]):
        ax.hist(y_prob[y_true[:, c] == 1, c], bins=25, alpha=0.6, label="pos", density=True)
        ax.hist(y_prob[y_true[:, c] == 0, c], bins=25, alpha=0.6, label="neg", density=True)
        ax.axvline(ths[c], color="k", linestyle="--", label=f"th={ths[c]:.2f}")
        ax.set_title(names[c])
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out / "score_histograms.png", dpi=120)
    plt.close(fig)

    # predicted-label correlation heatmap (cell 7)
    fig, ax = plt.subplots(figsize=(5.5, 5))
    im = ax.imshow(label_correlation(y_pred), vmin=-1, vmax=1, cmap="coolwarm")
    ax.set_xticks(range(n_classes), names, rotation=45)
    ax.set_yticks(range(n_classes), names)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out / "label_correlation.png", dpi=120)
    plt.close(fig)

    # per-class confusion matrices (cell 8)
    fig, axes = plt.subplots(2, 3, figsize=(12, 7))
    for c, ax in enumerate(axes.ravel()[:n_classes]):
        cm = np.zeros((2, 2), int)
        np.add.at(cm, (y_true[:, c].astype(int), y_pred[:, c].astype(int)), 1)
        ax.imshow(cm, cmap="Blues")
        for i in range(2):
            for j in range(2):
                ax.text(j, i, str(cm[i, j]), ha="center", va="center")
        ax.set_title(names[c])
        ax.set_xlabel("pred")
        ax.set_ylabel("true")
    fig.tight_layout()
    fig.savefig(out / "confusion_matrices.png", dpi=120)
    plt.close(fig)

    # beta distribution (cells 9-10)
    beta_path = pred_dir / f"{args.split}_beta_mean.npy"
    if beta_path.exists():
        beta = np.load(beta_path)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(beta, bins=30)
        ax.axvline(0.5, color="k", linestyle="--")
        ax.set_xlabel("mean β  (>0.5 audio-dominant, <0.5 text-dominant)")
        ax.set_ylabel("count")
        fig.tight_layout()
        fig.savefig(out / "beta_distribution.png", dpi=120)
        plt.close(fig)
        print(f"[β] mean={beta.mean():.3f} audio-dominant={100 * (beta > 0.5).mean():.1f}%")

    # dual attention heatmaps (cell 11)
    attn_path = pred_dir / f"{args.split}_attentions.pt"
    if attn_path.exists():
        import torch

        attn = torch.load(attn_path, weights_only=False)
        shown = 0
        for enc_layers, dec_layers in zip(attn["encoder"], attn["decoder"]):
            align = np.asarray(enc_layers[-1]["audio_queries_text"])  # [b, La, Lt]
            attrib = np.asarray(dec_layers[-1])                        # [b, E, L]
            for s in range(align.shape[0]):
                if shown >= args.max_attn_samples:
                    break
                fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
                a = align[s]
                # rows are softmax distributions that sum to ~1: only the
                # padded text columns can be cropped, as the notebook does
                cols = np.where(a.sum(0) > 1e-6)[0]
                if len(cols):
                    a = a[:, : cols[-1] + 1]
                ax1.imshow(a, aspect="auto", cmap="viridis")
                ax1.set_title("Cross-Modal Alignment (audio→text)")
                ax1.set_xlabel("text position")
                ax1.set_ylabel("audio frame")
                d = attrib[s]
                cols = np.where(d.sum(0) > 0)[0]
                if len(cols):
                    d = d[:, : cols[-1] + 1]
                ax2.imshow(d, aspect="auto", cmap="magma")
                ax2.set_yticks(range(len(names)), names)
                ax2.set_title("Emotion Attribution (queries→fused seq)")
                ax2.set_xlabel("fused position")
                fig.tight_layout()
                fig.savefig(out / f"attention_sample{shown}.png", dpi=120)
                plt.close(fig)
                shown += 1
            if shown >= args.max_attn_samples:
                break

    # exact-match case study (cell 12)
    exact = np.where((y_pred == y_true).all(axis=1))[0]
    print(f"[case-study] exact-match samples: {len(exact)}/{len(y_true)} "
          f"(first 10 idx: {exact[:10].tolist()})")
    with open(out / "case_study.txt", "w") as f:
        f.write(f"exact_match_count: {len(exact)}\nindices: {exact.tolist()}\n")

    print(f"[Saved] analysis figures to {out}")
    return out


if __name__ == "__main__":
    main()
