"""The port's index kinds as the harness builds and searches them, one
module per kind (the ``index`` key of a configuration): ``build`` (the
port's build of one chunk of documents), ``searcher``, ``need`` (the work
a search needs, from the configuration) and ``KERNEL_SOURCES``."""
