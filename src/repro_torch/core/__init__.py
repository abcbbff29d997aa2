"""Search engine, quantization and the population evaluator."""
