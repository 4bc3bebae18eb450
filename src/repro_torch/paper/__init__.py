"""The paper's own DNNs and their training harness (port of ``repro/paper``)."""
