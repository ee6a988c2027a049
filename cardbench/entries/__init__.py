"""One module a driver entry: how the harness calls it, what of its output
it keeps, how the plain reference judges that output, and the work its
block schedule gives the kernels' rooflines. ``harness.entry(name)``
finds a module by the ``entry`` of a cell's file."""
