"""Frame-alignment videos of the port's embeddings, the counterpart of the
root `visualize_alignment.py`.

    python -m video_rep_learning_tpu_torch.visualize_alignment --workdir DATA \\
        --cfg_file CFG --logdir RUN [--device cuda|cpu] [--use_dtw]
        [--query 0 --key 1 | --keys 1,2,3] [--labeled] [--time_stride 10]

Restores LOGDIR's newest checkpoint into the port's trainer, embeds the
first val loader's videos (`evaluation/embedding.py::get_embeddings_dataset`
on the device), maps each query frame to a key frame by DTW or nearest
neighbour (`align`), and renders a side-by-side video into LOGDIR
(`alignment_{q}_{k}.mp4`), or the reference's 1-query-vs-K 2x3 grid
(`alignment_multi_{q}.mp4`), and with `--labeled` the query alone with its
phase labels (`labeled_{q}.mp4`). Frames are drawn with matplotlib, which
is imported only by the render functions, and encoded by the native
encoder (a path ending in `.npy` stores the frames instead).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .utils.dtw import dtw


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def align(query_embs, key_embs, use_dtw: bool):
    """Map each query frame to a key frame (`visualize_alignment.py` align)."""
    if use_dtw:
        _, _, _, path = dtw(query_embs, key_embs, dist="sqeuclidean")
        _, uix = np.unique(path[0], return_index=True)
        return path[1][uix]
    from scipy.spatial.distance import cdist

    dists = cdist(query_embs, key_embs, "sqeuclidean")
    return np.argmin(dists, axis=1)


def render_pair_video(query_frames, key_frames, nns, out_path, fps=8,
                      time_stride=1, dpi=72):
    """Side-by-side (query | aligned key) video."""
    from .data.decode import encode_video

    plt = _pyplot()
    frames = []
    fig, axes = plt.subplots(1, 2, figsize=(8, 4), dpi=dpi)
    for t in range(0, len(query_frames), time_stride):
        for ax in axes:
            ax.clear()
            ax.axis("off")
        axes[0].imshow(query_frames[t])
        axes[0].set_title(f"query t={t}")
        axes[1].imshow(key_frames[int(nns[t])])
        axes[1].set_title(f"key t={int(nns[t])}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
    plt.close(fig)
    encode_video(out_path, np.stack(frames), fps=fps)
    print("wrote", out_path)


def render_multi_video(query_frames, key_frames_list, nns_list, out_path,
                       fps=8, time_stride=1, dpi=72):
    """One query against K aligned key videos in the reference's 2x3 grid
    (query top-left, keys filling the rest; `visualize_alignment.py:99-133`
    `create_multiple_video`). K <= 5."""
    K = len(key_frames_list)
    if K > 5:
        raise ValueError("2x3 grid supports at most 5 key videos")
    from .data.decode import encode_video

    plt = _pyplot()
    frames = []
    fig, axes = plt.subplots(2, 3, figsize=(9, 6), dpi=dpi)
    for t in range(0, len(query_frames), time_stride):
        for ax in axes.ravel():
            ax.clear()
            ax.axis("off")
        axes[0, 0].imshow(query_frames[t])
        axes[0, 0].set_title(f"query t={t}", fontsize=8)
        for k in range(K):
            ax = axes[(k + 1) // 3, (k + 1) % 3]
            j = int(nns_list[k][t])
            ax.imshow(key_frames_list[k][j])
            ax.set_title(f"key{k} t={j}", fontsize=8)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    encode_video(out_path, np.stack(frames), fps=fps)
    print("wrote", out_path)


def render_labeled_video(frames_in, labels, out_path, fps=8, time_stride=1,
                         dpi=72):
    """Single video with its per-frame phase label rendered in the title
    (`visualize_alignment.py:134-170` `create_single_video`, which prints
    the strided labels and animates the frames)."""
    from .data.decode import encode_video

    plt = _pyplot()
    print(np.asarray(labels)[::time_stride])
    frames = []
    fig, ax = plt.subplots(figsize=(5, 5), dpi=dpi)
    for t in range(0, len(frames_in), time_stride):
        ax.clear()
        ax.axis("off")
        ax.imshow(frames_in[t])
        ax.set_title(f"t={t}  label={int(labels[t])}", fontsize=10)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    encode_video(out_path, np.stack(frames), fps=fps)
    print("wrote", out_path)


def load_val_embeddings(argv, extra: argparse.ArgumentParser):
    """The visualizers' compute half: parse `extra`'s flags and the
    training CLI's (with `--device`), restore LOGDIR's newest checkpoint
    into the port's trainer and embed the first val loader. Returns
    (extra's namespace, cfg, the loader's items, their embeddings
    dataset)."""
    from .evaluate import parse_cli
    from .evaluation.embedding import get_embeddings_dataset
    from .parser import load_config
    from .tools.common import resolve_device
    from .train import Trainer

    ns, rest = extra.parse_known_args(argv)
    args, device = parse_cli(rest)
    device = resolve_device(device)
    cfg = load_config(args)
    cfg.PATH_TO_DATASET = os.path.join(args.workdir, cfg.PATH_TO_DATASET)
    trainer = Trainer(cfg, device=device)
    trainer.init_state()
    ds = get_embeddings_dataset(cfg, trainer.model, trainer.val_emb_loader[0], device)
    items = list(trainer.val_emb_loader[0])
    return ns, cfg, items, ds


def parser():
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--use_dtw", action="store_true")
    extra.add_argument("--query", type=int, default=0)
    extra.add_argument("--key", type=int, default=1)
    extra.add_argument("--keys", type=str, default=None,
                       help="comma-separated key indices (<=5): render the "
                            "reference's 1-query-vs-K 2x3 grid instead of "
                            "the pair video")
    extra.add_argument("--labeled", action="store_true",
                       help="also render the query video alone with its "
                            "per-frame phase labels")
    extra.add_argument("--time_stride", type=int, default=10)
    return extra


def main(argv=None):
    """Returns the paths written."""
    ns, cfg, loader_items, ds = load_val_embeddings(argv, parser())
    q = ns.query
    outputs = []
    if ns.keys:
        keys = [int(s) for s in ns.keys.split(",")]
        nns_list = [align(ds["embs"][q], ds["embs"][k], ns.use_dtw) for k in keys]
        outputs.append(os.path.join(cfg.LOGDIR, f"alignment_multi_{q}.mp4"))
        render_multi_video(loader_items[q]["video"],
                           [loader_items[k]["video"] for k in keys], nns_list,
                           outputs[-1], time_stride=ns.time_stride)
    else:
        k = ns.key
        nns = align(ds["embs"][q], ds["embs"][k], ns.use_dtw)
        outputs.append(os.path.join(cfg.LOGDIR, f"alignment_{q}_{k}.mp4"))
        render_pair_video(loader_items[q]["video"], loader_items[k]["video"], nns,
                          outputs[-1], time_stride=ns.time_stride)
    if ns.labeled:
        outputs.append(os.path.join(cfg.LOGDIR, f"labeled_{q}.mp4"))
        render_labeled_video(loader_items[q]["video"], loader_items[q]["labels"],
                             outputs[-1], time_stride=ns.time_stride)
    return outputs


if __name__ == "__main__":
    main()
