"""The benchmark of `wavespec_tpu_torch`, the PyTorch and CUDA port:
`python -m wsbench --workload <name> --seed <n> --seconds <s> --trace <0|1>`.
See README.md."""
