from .synthetic import Corpus, CorpusConfig, make_batches  # noqa: F401
