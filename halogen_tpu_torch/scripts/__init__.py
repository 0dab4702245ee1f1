"""The JAX package's user-facing scripts (`scripts/`), ported: each runs
on the card unless it is given `--cpu` (or `--small`, at tiny shapes),
writes under `perf/torch/` and `renders/torch/` of the working directory
or where `--out`/`--out-dir` says, and names in its record the device it
ran on (the card's name and power limit as `nvidia-smi` gives them, or
"cpu"). Run them as modules:

    python -m halogen_tpu_torch.scripts.hero_run        # 512², 4096 spp
    python -m halogen_tpu_torch.scripts.inverse_demo
    python -m halogen_tpu_torch.scripts.turntable --scene glass_dragon
    python -m halogen_tpu_torch.scripts.variance_bench
    python -m halogen_tpu_torch.scripts.gen_goldens

Each module's `main(argv)` returns its record (a list of them where the
script writes several) and prints it as JSON.
"""
