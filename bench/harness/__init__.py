"""The harness: loading a cell by name, the generator, the trace reader,
the comparison that decides ``correct`` and one run of a cell."""
