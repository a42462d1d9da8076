"""The benchmark's harness: the catalogue of cells, configurations, traffic
and metrics found by name (``catalog``), the seeded scene (``scene``), the
per-particle view of the program's state (``dense``), the comparisons that
decide ``correct`` (``checks``), the trace and its reduction (``trace``),
the Session's episodes (``episodes``) and one run of a cell
(``harness``)."""
