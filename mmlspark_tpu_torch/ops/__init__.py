"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; the image and text stages. Each stage name loads its module on
first use."""

_EXPORTS = {
    "ImageTransformer": "image_stages", "UnrollImage": "image_stages",
    "ImageSetAugmenter": "image_stages",
    "TextFeaturizer": "text_stages", "TextFeaturizerModel": "text_stages",
    "Word2Vec": "word2vec", "Word2VecModel": "word2vec",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                   name)
