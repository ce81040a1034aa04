"""Auxiliary subsystems: matrix generation, printing, debug (analog of
reference src/auxiliary/; counterpart of ``slate_tpu/utils/``)."""
