"""Algorithm 1 host logic, aggregation, distillation and the engine."""
