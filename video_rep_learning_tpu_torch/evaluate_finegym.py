"""FineGym evaluation entry point under the reference's name
(`evaluate_finegym.py`): `evaluate.main` already runs the FineGym harness
when DATASETS[0] is finegym.

    python -m video_rep_learning_tpu_torch.evaluate_finegym --workdir DATA_ROOT \\
        --cfg_file configs_mvf/fg99_mvf.yml --logdir LOGDIR \\
        [--device cuda] [--opts KEY VALUE ...]
"""

from .evaluate import main

if __name__ == "__main__":
    main()
