"""The benchmark's general code: the cell's files found by name, spans and
counters over the program's functions, the profiler's reading, the FLOP
count and peaks, seeded openings, and the comparison with the plain
reference that decides ``correct``."""
