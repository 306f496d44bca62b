"""The port's counterpart of ``paddle_tpu.fluid``.  So far it holds only
the ops the paged serving path runs (``fluid.ops``); the ProgramDesc
front end, lowering and Executor are not ported yet."""
