"""Operations and bytes of each kernel call, one file per entry point of
the port, frozen here so that a later change to the program cannot
change the yardstick.  Each file gives ``ENTRY`` (the module and the
function of the entry point), ``shapes(args, probe)`` (what one call
leaves for the count: ``args`` its arguments by name; ``probe.meta``
keeps a tensor's shape, ``probe.keep`` an index tensor's contents) and
``least_ms(call)``: the least time the card could take for the call, the
larger of its operations over the bf16 peak and its bytes over the
memory bandwidth (``portbench.peaks``).  The profiler range around the
entry point's calls is named after the file (``portbench.probes``)."""
