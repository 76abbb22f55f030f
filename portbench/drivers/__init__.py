"""One module a kind of traffic, found by the traffic file's ``driver`` key
(``train``, ``sampling``): a new kind is a new file here. A driver makes
the cell's inputs and weights from the seeds, drives the program's own calls (``setup`` and ``unit``), reports
the end-to-end metrics of a window, counts the model's FLOPs of a unit on
the reference, and after the window reads the program's outputs against the
reference (``check``).

The interface:

- ``setup()``: load, make weights and inputs, warm up the cell's shapes;
- ``unit(i)``: one unit of traffic (a call of K train steps, a request);
- ``drain()``: wait for the device;
- ``end_to_end(window_s, units)``: every end-to-end quantity the driver
  measures, by metric name (``setup_s`` aside); the harness reports those
  that ``BENCHMARK.json`` gives the cell;
- ``flops_per_unit()``: the model's FLOPs of one unit, counted on the
  reference at the cell's shapes on the meta device;
- ``release()``: free the program's state;
- ``check(precision)``: the numbers compared with the reference, by name.
"""
