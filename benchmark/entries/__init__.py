"""The drivers of the benchmark's kinds of traffic, one file each, found by
the ``"entry"`` of a configuration (``entries/<entry>.py``, class
``Entry``).  An entry is built with the run (``harness.main.Run``) and
offers ``warm_up``, ``start_window``, ``play(seconds=, units=)``,
``segment_start``, ``end_to_end``, ``attempted_failed``, ``release`` and
``check``; the general parameters of its traffic come from the mix's data
file."""
