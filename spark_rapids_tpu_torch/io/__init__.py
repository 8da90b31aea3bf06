"""File sources and sinks: the parquet scan (``parquet``), its page-level
dictionary and run-length reader (``parquet_pages``, a byte-equal copy of
the JAX package's), the CSV and ORC scans (``csv``, ``orc``, with the ORC
footer reader ``orc_meta``, a copy), the writers and their commit protocol
(``writer``, a copy) and the write command (``write_exec``), the shared
file-datasource machinery (``datasource``) and the legacy-calendar rebase
(``rebase``, a byte-equal copy). Unlike the rest of the port, these
modules need pyarrow; nothing on an in-memory table's path imports
them."""
