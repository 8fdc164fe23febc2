"""PyTorch / CUDA port of the Fed-RAC reproduction (``repro``).

Mirrors ``repro``'s layout (``core``, ``kernels``, ``models``, ``data``,
``launch``) and imports nothing of it, nor of JAX.  Entry points run on
``cuda`` unless the caller asks for ``cpu``.
"""
