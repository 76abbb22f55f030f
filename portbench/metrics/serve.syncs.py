from portbench.metrics._program import count_per_unit

read = count_per_unit("sample.request", "host.sync")
