"""One module a driver entry: how the harness calls it, what of its output
it keeps, how the plain reference judges that output, and the work its
block schedule gives the kernels' rooflines. ``harness.entry(name)``
finds a module by the ``entry`` of a cell's file.

An entry defines ``prepare(settings)``, ``call(inp, state, prep)``,
``check(inp, out, settings)`` (the numbers its plain reference reads),
``schedule(shape, settings)`` and optionally ``phases``; ``NUMBERS``, the
names ``check`` returns; ``LIMITED``, those that every cell of the entry
holds to a limit; and optionally ``FAULTS``, its own faults by name
(``faults.find``), for what ``faults.FAULTS`` cannot break in it."""
