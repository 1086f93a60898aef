"""The training stack (counterpart of ``bokego_tpu/train/``): datasets and
D4 augmentation, checkpoints and the opponent pool, supervised learning,
policy and value data generation, REINFORCE and AlphaZero."""
