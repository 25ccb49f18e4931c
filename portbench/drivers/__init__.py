"""One module a kind of run, named by a traffic mix's ``driver``: it builds
the program from the configuration, feeds it the traffic, drives the window
and compares with the plain reference."""
