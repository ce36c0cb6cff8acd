"""Command-line examples (counterpart of ``bigdl_tpu.examples``)."""
