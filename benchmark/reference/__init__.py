"""The benchmark's plain reference: rules (:mod:`.rules`), the 27 feature
planes (:mod:`.features`) and the nets' float32 forward (:mod:`.nets`), in
plain Python, NumPy and PyTorch on the CPU.  Nothing here imports the
program under test."""
