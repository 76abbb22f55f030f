from portbench.metrics._program import prepare_ms

read = prepare_ms("sample.request")
