"""Offline tools of the port (counterpart of ``ddl_tpu/tools/``)."""
