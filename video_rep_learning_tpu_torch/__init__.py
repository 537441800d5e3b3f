"""PyTorch / CUDA port of `video_rep_learning_tpu` for one NVIDIA H100.

The JAX package stays the reference. This package keeps its module and
class names, imports only its backend-neutral modules (`config`, `parser`,
`data`, `utils`), and replaces each Pallas kernel on the ported path with a
kernel written by hand for Hopper (`csrc/`, built with nvcc at first use).

Ported so far: the CARL embedding (serving) path, from uint8 frames to
L2-normalised per-frame embeddings and the downstream eval tasks
(`python -m video_rep_learning_tpu_torch.evaluate`).
"""

__version__ = "0.1.0"
