"""One module a system under test, named by a configuration's
``"system"``: how the benchmark builds the program's decoder for the
configuration, what the frozen transmitter sends it, the plain reference
of its front, and the shapes its kernels are counted at."""
