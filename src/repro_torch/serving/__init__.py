"""Serving: wave scheduling, the topic-model engines and the transformer engine.

  scheduler     `WaveScheduler`: submit / bucket / drain in bounded waves
  batch_engine  buckets compatible models and runs each bucket as one
                stacked sampler run (`core.batch`, the batched kernels)
  topic_engine  `TopicEngine`: fit-and-view serving of many products over
                the wire, a compatible wave in one `fit_batch` call
  engine        `Engine`: the transformer zoo's batched prefill + decode
                (the dense, ssm and hybrid families)
"""

from repro_torch.serving.scheduler import WaveScheduler  # noqa: F401


def __getattr__(name):  # lazy: the engines pull in the model and api layers
    if name in ("Engine", "Request", "Result"):
        from repro_torch.serving import engine

        return getattr(engine, name)
    if name in ("TopicEngine", "TopicResult"):
        from repro_torch.serving import topic_engine

        return getattr(topic_engine, name)
    if name == "batch_engine":
        import importlib

        return importlib.import_module("repro_torch.serving.batch_engine")
    raise AttributeError(f"module 'repro_torch.serving' has no attribute {name!r}")
