"""Crash-safe run-state checkpoints: the file format (``checkpoint``), the
CRC32-manifested directory (``manifest``) and the run-state envelope
(``run_state``).  Files are byte-identical to the JAX package's for the same
arrays, so each package reads the other's."""
