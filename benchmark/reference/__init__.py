"""The plain reference of the aligner the benchmark judges."""
