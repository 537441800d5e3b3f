"""`python -m video_rep_learning_tpu_torch.train`: see `train/cli.py`."""

from .cli import main

main()
