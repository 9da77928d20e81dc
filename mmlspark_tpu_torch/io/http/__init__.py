"""HTTP serving and client stages of the PyTorch port (the port's own copy
of ``mmlspark_tpu/io/http``): the source, sink and polling loop, N servers
behind one loop, the worker process, and the client stages over the
standard library's ``urllib``. The serving fleet (``fleet.py``:
``ProcessHTTPSource``, ``ReplayServingLoop``, ``serve_fleet``) waits for
ROADMAP.md Queue 1 item 13b."""
from .distributed import (DistributedHTTPSource, DistributedServingLoop,
                          SharedVariable, serve_distributed)
from .server import HTTPSink, HTTPSource, ServingLoop, serve_pipeline
from .transformer import (CustomInputParser, CustomOutputParser,
                          HTTPTransformer, JSONInputParser, JSONOutputParser,
                          SimpleHTTPTransformer, StringOutputParser)

__all__ = [n for n in dir() if not n.startswith("_")]
