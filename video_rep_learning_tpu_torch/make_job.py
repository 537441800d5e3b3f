"""Generate job scripts for training runs of the port: the root
`make_job.py`'s trials, `--micro`, seeds and `--template`, each script
running `python -m video_rep_learning_tpu_torch.train ... --device cuda`.

    python -m video_rep_learning_tpu_torch.make_job --cfg_file CFG \\
        --workdir DATA --logdir RUN [--trials 3] [--seed 1] [--micro] \\
        [--template job.tmpl] [--out_dir jobs]

Multi-trial launches with per-trial RNG seeds (`-trialNN` logdirs, read
back by `read_results.py`), and a `--micro` debug mode that forces a
2-epoch run with per-epoch val and checkpoints (`EVAL.VAL_INTERVAL 1
CHECKPOINT.SAVE_INTERVAL 1 TRAIN.MAX_EPOCHS 2`), as the reference's job
generator (`make_job.py:12-115`). One script a trial, from a template with
{name} and {command} fields (`--template`, else the built-in one). The
command is one process on one card; a template that starts N processes,
one a card, adds the rank flags itself (`--coordinator HOST:PORT
--num_processes N --process_id R`, README).
"""

import argparse
import os
import stat

BUILTIN_TEMPLATE = """#!/bin/bash
# job: {name}
set -e
cd "$(dirname "$0")/.."
{command}
"""


def build_command(args, trial):
    seed = args.seed + trial
    logdir = args.logdir
    if args.trials > 1:
        logdir = f"{logdir}-trial{trial:02d}"
    opts = [f"RNG_SEED {seed}"]
    if args.micro:
        logdir = logdir + "-micro"
        opts += ["EVAL.VAL_INTERVAL 1", "CHECKPOINT.SAVE_INTERVAL 1",
                 "TRAIN.MAX_EPOCHS 2"]
    opt_str = " ".join(opts)
    return (f"python -m video_rep_learning_tpu_torch.train --workdir {args.workdir} "
            f"--cfg_file {args.cfg_file} --logdir {logdir} --device cuda "
            f"--opts {opt_str}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--logdir", required=True)
    p.add_argument("--out_dir", default="jobs")
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--micro", action="store_true",
                   help="2-epoch debug job exercising the full pipeline")
    p.add_argument("--template", default=None,
                   help="script template with {name} and {command} fields")
    args = p.parse_args(argv)

    template = BUILTIN_TEMPLATE
    if args.template:
        with open(args.template) as f:
            template = f.read()

    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.cfg_file))[0]
    for trial in range(args.trials):
        name = base + (f"-trial{trial:02d}" if args.trials > 1 else "")
        if args.micro:
            name += "-micro"
        path = os.path.join(args.out_dir, name + ".sh")
        with open(path, "w") as f:
            f.write(template.format(name=name, command=build_command(args, trial)))
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        print("wrote", path)


if __name__ == "__main__":
    main()
