from repro_torch.serving.engine import (ContinuousBatchingEngine, Request,
                                        ServingEngine, StreamSimulator)

__all__ = ["ContinuousBatchingEngine", "Request", "ServingEngine",
           "StreamSimulator"]
