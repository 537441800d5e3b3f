"""PyTorch / CUDA port of `video_rep_learning_tpu` for one NVIDIA H100.

The JAX package stays the reference. This package keeps its module and
class names, keeps its own copies of the backend-neutral modules (`config`,
`parser`, `data`, `utils`), imports nothing of the JAX package, and replaces
each Pallas kernel on the ported paths with a kernel written by hand for
Hopper (`csrc/`, built with nvcc at first use).

Ported so far: the embedding (serving) path of every shipped config, from
uint8 frames to L2-normalised per-frame embeddings and the downstream eval
tasks or the FineGym harness (`python -m video_rep_learning_tpu_torch.evaluate`,
`.evaluate_finegym`), and training with SCL, TCC, TCN or classification
with epoch and mid-epoch checkpoints (`python -m
video_rep_learning_tpu_torch.train`), in a single process.
"""

__version__ = "0.2.0"
