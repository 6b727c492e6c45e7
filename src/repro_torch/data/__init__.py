from .synthetic import Corpus, CorpusConfig, arch_extras_fn, make_batches  # noqa: F401
