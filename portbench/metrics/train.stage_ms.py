from portbench.metrics._program import span_ms

read = span_ms("train.call", "train.stage")
