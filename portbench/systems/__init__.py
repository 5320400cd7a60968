"""One module a system the benchmark drives, named by a configuration's
``system`` key; each holds the program's adapter (``Port``), the control
(``Control``) and the epoch runner (``Cell``)."""
