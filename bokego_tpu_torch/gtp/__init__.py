"""GTP engine and subprocess match harness of the port."""
