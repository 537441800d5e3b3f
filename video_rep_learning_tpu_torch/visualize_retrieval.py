"""Frame-retrieval videos of the port's embeddings, the counterpart of the
root `visualize_retrieval.py`.

    python -m video_rep_learning_tpu_torch.visualize_retrieval --workdir DATA \\
        --cfg_file CFG --logdir RUN [--device cuda|cpu] [--query 0] [--topk 5]

Embeds the first val loader's videos with LOGDIR's newest checkpoint (as
`visualize_alignment.py`), then renders `retrieval_{q}.mp4` into LOGDIR:
every 5th frame of the query beside its K nearest frames by squared L2
distance among the other val videos' frames (`retrieve`). matplotlib is
imported only by the render function.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .visualize_alignment import _pyplot, load_val_embeddings


def retrieve(query_embs, cand_embs, K):
    """(T, K) indices of each query frame's K nearest candidate frames by
    squared L2 distance, nearest first (`visualize_retrieval.py:32-33`)."""
    from scipy.spatial.distance import cdist

    return np.argsort(cdist(query_embs, cand_embs, "sqeuclidean"), axis=1)[:, :K]


def create_retrieval_video(query_frames, query_embs, candidates, out_path,
                           K=5, fps=4, dpi=72, stride=5):
    """candidates: list of (frames, embs) from other videos."""
    from .data.decode import encode_video

    cand_frames = np.concatenate([c[0] for c in candidates], axis=0)
    cand_embs = np.concatenate([c[1] for c in candidates], axis=0)
    topk = retrieve(query_embs, cand_embs, K)

    plt = _pyplot()
    frames = []
    fig, axes = plt.subplots(1, K + 1, figsize=(2 * (K + 1), 2.4), dpi=dpi)
    for t in range(0, len(query_frames), stride):
        for ax in axes:
            ax.clear()
            ax.axis("off")
        axes[0].imshow(query_frames[t])
        axes[0].set_title(f"query t={t}", fontsize=8)
        for j in range(K):
            axes[j + 1].imshow(cand_frames[topk[t, j]])
            axes[j + 1].set_title(f"top{j + 1}", fontsize=8)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    encode_video(out_path, np.stack(frames), fps=fps)
    print("wrote", out_path)


def main(argv=None):
    """Returns the path written."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--query", type=int, default=0)
    extra.add_argument("--topk", type=int, default=5)
    ns, cfg, items, ds = load_val_embeddings(argv, extra)
    q = ns.query
    out = os.path.join(cfg.LOGDIR, f"retrieval_{q}.mp4")
    candidates = [(items[i]["video"], ds["embs"][i]) for i in range(len(items)) if i != q]
    create_retrieval_video(items[q]["video"], ds["embs"][q], candidates, out, K=ns.topk)
    return out


if __name__ == "__main__":
    main()
