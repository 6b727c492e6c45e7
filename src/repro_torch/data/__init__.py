from .synthetic import Corpus, CorpusConfig  # noqa: F401
