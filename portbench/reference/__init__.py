"""The plain reference the benchmark holds the port to: float64 torch
on the run's device, its own geometry (``frozen``), assembly
(``cutfem``) and time loops (``advection``, ``wave``), and the numbers
that decide ``correct`` (``compare``).  It imports nothing of the port
and takes nothing the port computed."""
