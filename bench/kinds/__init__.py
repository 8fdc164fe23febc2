"""Adapters from a configuration file to the program's model family, one
module per ``kind`` (the configuration's ``"kind"``), found by that name:
a kind joins the benchmark as a new module here, its plain reference as
``bench/reference/<reference>.py`` (the configuration's ``"reference"``:
``init``, ``sizes``, ``step_loss``, ``teacher_logits``, ``evaluate``),
and no edit of the harness.

A kind module gives ``UNIT`` (what ``units_per_sample`` counts),
``EVAL_IS_ACCURACY`` (the check compares its evaluations in test samples
where true, relatively where false), ``family(cfg)``, ``classes(cfg)``,
``engine_base(srv)`` (the engine class with the kind's documented
hooks), ``units_per_sample(traffic)`` and ``flops_per_call(cfg, traffic,
members, n_test)``, the model FLOPs of a ``train()`` call that ``mfu``
reads."""
