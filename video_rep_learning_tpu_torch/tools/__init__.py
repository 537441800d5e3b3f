"""H100 micro-benchmarks of the port's kernels, the counterparts of the TPU
scripts `tools/bench_ln_matmul.py`, `tools/bench_packed_attn.py`,
`tools/bench_attn_variants.py`, `tools/bench_int8_pallas.py` and
`tools/bench_vpu_bf16.py` at those scripts' shapes. Each module has
`run(device="cuda", **shapes)`, which returns one row dict a variant, and a
`main()`:

    python -m video_rep_learning_tpu_torch.tools.<name> [--device cpu]

On the card every row holds the kernel against its plain version and times
the kernel, the plain version and, where one PyTorch call computes the same
function, that call, with CUDA events. On the CPU the wrappers take their
plain versions and nothing is timed.

`ddp_cards` is no micro-benchmark: it times a config's warm training steps
(or epochs of the training loop) at each world size, one process a card
over NCCL (gloo on the CPU), and checks that the ranks stay bit-identical.
`bench_eval` times the eval sweeps (per-video, frame-packed, packed) on a
ragged set staged on the card, and `bench_host_pipeline` the train loader
alone on the host: the counterparts of `tools/bench_eval.py` and
`tools/bench_host_pipeline.py`.
"""
