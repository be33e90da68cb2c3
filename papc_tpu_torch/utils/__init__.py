"""Utilities of the port (counterpart of ``papc_tpu.utils``)."""
