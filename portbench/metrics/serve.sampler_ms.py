from portbench.metrics._read import span_ms

read = span_ms("sampler")
