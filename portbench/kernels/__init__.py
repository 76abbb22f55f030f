"""One file a kernel of the port: the names its launches take in the device
trace (``PATTERNS``), its name in the program's launch counter
(``LAUNCH``), the peak its operations run at (``PEAK``) and ``launches(cell)``,
the bytes and operations of each launch in one unit of the cell's traffic
(an empty list where the cell's path does not run it). The harness finds
every file here by name."""
