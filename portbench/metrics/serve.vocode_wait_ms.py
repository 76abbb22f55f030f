from portbench.metrics._program import span_ms

read = span_ms("sample.request", "vocode.readback")
