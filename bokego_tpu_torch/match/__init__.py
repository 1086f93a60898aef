"""Engine-vs-engine matches of the port (counterparts of the JAX package's
match tools under ``tools/``), one entry point each:

    python -m bokego_tpu_torch.match.weights_match      # two weight sets, one config
    python -m bokego_tpu_torch.match.config_match       # two search configs, shared nets
    python -m bokego_tpu_torch.match.fastmode_fidelity  # the kernel config against the exact one
    python -m bokego_tpu_torch.match.policy_curve       # raw policies against a fixed opponent
    python -m bokego_tpu_torch.match.serving_match      # two timed GTP engines, native referee

Each takes ``--device`` (default ``cuda``: without a GPU they raise unless
``--device cpu`` is given), serves the nets in fp32, and prints its result
lines in the format of the JAX tool it ports, so readers of the old logs
(``tools/elo_table.py``) read the new ones too.
"""
