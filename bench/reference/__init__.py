"""The plain reference: Fed-RAC's ``train()`` recomputed in plain PyTorch
and NumPy, fp32, one member at a time, from the benchmark's own inputs.
It imports nothing of the program under test.  One module per model,
named by a configuration's ``"reference"`` (``fedrac.model_module``)."""
