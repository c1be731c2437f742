"""Plain float32 references of the models the port serves, each a file of
its own that imports ``torch``, ``math`` and ``numpy`` and nothing of the
port, for the tests and the benchmark's check of ``correct``."""
