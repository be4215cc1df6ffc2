"""Cluster-level fault-tolerance helpers of the port (a copy of the JAX
package's ``distributed/fault_tolerance.py``)."""
