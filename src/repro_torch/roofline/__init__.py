"""Roofline of the port: an H100 SXM row (``hw``), a per-device counter of
the operations a step runs (``op_analysis``), the roofline terms and the
analytic model FLOPs (``analysis``), and the dry-run table (``report``)."""
