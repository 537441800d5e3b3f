"""LSTP attention-map videos of an MV-Former, the counterpart of the root
`visualize_lstp.py`.

    python -m video_rep_learning_tpu_torch.visualize_lstp --workdir DATA \\
        --cfg_file configs_mvf/pouring_mvf.yml --logdir RUN [--device cuda|cpu]
        [--video N] [--max_frames 40] [--samples_per 5]

The attention is captured as the reference captures it (its `attn_holder`
hook, `visualize_lstp.py:35-261`): a forward hook on `model.embed.pooling`
keeps the second output of the LSTP module, (frames, tokens, S) with S the
patch grid's tokens, while the model runs its ordinary eval forward; the
model's code and outputs do not change. On a card the ViT runs with its
kernels there.

By default every val embedding loader is swept (`run_sweep`, reference
`run_vis`, `visualize_lstp.py:74-115`): `samples_per` videos of each (5
with one dataset, else 1), each chunked by EVAL.FRAMES_PER_BATCH with the
maps concatenated and invalid (label < 0) frames dropped, rendered as one
heatmap overlay a token into LOGDIR (`lstp_<run>[_datasetNN][_sampleNN].mp4`).
`--video N` renders the first `--max_frames` (40) frames of that index of
the first loader (`lstp_N.mp4`). matplotlib is imported only by the render
function.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

from .visualize_alignment import _pyplot


def capture_lstp_attention(model, video_chunk, dims, image_size, device):
    """Run the model on (T, H, W, 3) uint8 frames (eval preprocessing, one
    clip, every frame valid), returning the LSTP attention (T, ntok, S) as
    fp32 numpy."""
    from .ops.augment import eval_augment

    v = torch.as_tensor(np.array(video_chunk), device=device).float() / 255.0
    v = eval_augment(v, image_size, dims=(float(dims[0]), float(dims[1])))
    held = []
    hook = model.embed.pooling.register_forward_hook(
        lambda module, args, out: held.append(out[1]))
    try:
        with torch.inference_mode():
            model(v[None], None, video_masks=torch.ones(1, 1, v.shape[0], device=device),
                  project=False)
    finally:
        hook.remove()
    return held[0].float().cpu().numpy()


def capture_lstp_attention_chunked(model, item, image_size, max_fpb, device):
    """Whole-video capture via the reference's chunking rule
    (`visualize_lstp.py:86-106`: num_batches = ceil(len/max), equal chunks,
    attention maps concatenated), then invalid (label < 0) frames dropped."""
    video = item["video"]
    seq_len = int(item["seq_len"])
    num_batches = int(math.ceil(float(seq_len) / max_fpb))
    fpb = int(math.ceil(float(seq_len) / num_batches))
    atts = []
    for i in range(num_batches):
        curr = i * fpb
        num_steps = min(seq_len - curr, fpb)
        chunk = video[curr:curr + num_steps]
        atts.append(capture_lstp_attention(model, chunk, item["dims"], image_size,
                                           device))
    att = np.concatenate(atts, axis=0)
    valid = np.asarray(item["labels"]) >= 0
    return att[valid], video[valid]


def render_attention_video(frames, attention, out_path, fps=6, dpi=72):
    """frames (T, H, W, 3); attention (T, ntok, S) with S a square grid."""
    T, ntok, S = attention.shape
    g = int(np.sqrt(S))
    if g * g != S:
        sys.exit("can only visualize a square token array")
    from .data.decode import encode_video

    plt = _pyplot()
    fig, axes = plt.subplots(1, ntok + 1, figsize=(2.2 * (ntok + 1), 2.4),
                             dpi=dpi)
    out_frames = []
    for t in range(T):
        for ax in axes:
            ax.clear()
            ax.axis("off")
        axes[0].imshow(frames[t])
        axes[0].set_title(f"t={t}", fontsize=8)
        for k in range(ntok):
            amap = attention[t, k].reshape(g, g)
            axes[k + 1].imshow(frames[t])
            axes[k + 1].imshow(
                np.kron(amap, np.ones((frames.shape[1] // g,
                                       frames.shape[2] // g))),
                alpha=0.6, cmap="jet")
            axes[k + 1].set_title(f"token {k}", fontsize=8)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        # H.264 requires even dimensions; the dynamic ntok figsize can land odd
        buf = buf[: buf.shape[0] // 2 * 2, : buf.shape[1] // 2 * 2]
        out_frames.append(buf.copy())
    plt.close(fig)
    encode_video(out_path, np.stack(out_frames), fps=fps)
    print("wrote", out_path)


def run_sweep(cfg, model, val_emb_loaders, samples_per, device, max_frames=None):
    """The reference's all-datasets sweep (`visualize_lstp.py:74-115`):
    `samples_per` videos from each val loader, each rendered; returns the
    paths written."""
    config_name = os.path.basename(cfg.LOGDIR.rstrip("/"))
    nds = len(val_emb_loaders)
    outputs = []
    for data_i, loader in enumerate(val_emb_loaders):
        cur_sample = 1
        for item in loader:
            att, frames = capture_lstp_attention_chunked(
                model, item, cfg.IMAGE_SIZE, cfg.EVAL.FRAMES_PER_BATCH, device)
            if max_frames:
                att, frames = att[:max_frames], frames[:max_frames]
            name = f"lstp_{config_name}"
            if nds > 1:
                name += f"_dataset{data_i:02d}"
            if samples_per > 1:
                name += f"_sample{cur_sample:02d}"
            out = os.path.join(cfg.LOGDIR, name + ".mp4")
            render_attention_video(frames, att, out)
            outputs.append(out)
            if cur_sample >= samples_per:
                break
            cur_sample += 1
    return outputs


def main(argv=None):
    """Returns the paths written."""
    from .evaluate import parse_cli
    from .parser import load_config
    from .tools.common import resolve_device
    from .train import Trainer

    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--video", type=int, default=None,
                       help="render only this index from the first loader")
    extra.add_argument("--max_frames", type=int, default=None)
    extra.add_argument("--samples_per", type=int, default=None,
                       help="override the reference's 5-if-single-dataset "
                            "/ 1-per-dataset rule")
    ns, rest = extra.parse_known_args(argv)
    args, device = parse_cli(rest)
    device = resolve_device(device)
    cfg = load_config(args)
    cfg.PATH_TO_DATASET = os.path.join(args.workdir, cfg.PATH_TO_DATASET)
    if cfg.MODEL.EMBEDDER_MODEL.FUSION_TYPE != "smart":
        sys.exit("visualize_lstp requires a smart-fusion (MV-Former) config")
    if int(cfg.DATA.NUM_CONTEXTS) != 1:
        sys.exit("num_contexts != 1 not supported")  # ref :65-67

    trainer = Trainer(cfg, device=device)
    trainer.init_state()

    if ns.video is not None:
        item = list(trainer.val_emb_loader[0])[ns.video]
        frames = item["video"][: ns.max_frames or 40]
        att = capture_lstp_attention(trainer.model, frames, item["dims"],
                                     cfg.IMAGE_SIZE, device)
        out = os.path.join(cfg.LOGDIR, f"lstp_{ns.video}.mp4")
        render_attention_video(frames, att, out)
        return [out]

    samples_per = ns.samples_per
    if samples_per is None:
        samples_per = 5 if len(cfg.DATASETS) == 1 else 1
    return run_sweep(cfg, trainer.model, trainer.val_emb_loader, samples_per, device,
                     max_frames=ns.max_frames)


if __name__ == "__main__":
    main()
