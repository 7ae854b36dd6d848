"""Part of the benchmark's frozen reference (see ``benchmark/reference``)."""
