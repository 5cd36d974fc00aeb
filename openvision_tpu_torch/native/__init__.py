"""The port's native host code: the WordPiece tokenizer and the shard
indexer in C++, built with the host's g++ at first use (``build.py``) and
bound through ctypes (``wordpiece.py``, ``indexer.py``)."""
