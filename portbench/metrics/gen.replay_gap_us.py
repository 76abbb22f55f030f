from portbench.metrics._program import replay_gap_us

read = replay_gap_us("sample.request")
