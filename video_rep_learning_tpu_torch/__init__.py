"""PyTorch / CUDA port of `video_rep_learning_tpu` for one NVIDIA H100.

The JAX package stays the reference. This package keeps its module and
class names, keeps its own copies of the backend-neutral modules (`config`,
`parser`, `data`, `utils`), imports nothing of the JAX package, and replaces
each Pallas kernel on the ported paths with a kernel written by hand for
Hopper (`csrc/`, built with nvcc at first use).

Ported so far: the CARL embedding (serving) path, from uint8 frames to
L2-normalised per-frame embeddings and the downstream eval tasks
(`python -m video_rep_learning_tpu_torch.evaluate`), and CARL SCL training
(`python -m video_rep_learning_tpu_torch.train`).
"""

__version__ = "0.2.0"
