"""DemoKohonen: 2-D point clusters self-organized onto an 8x8 map.

The port's counterpart of ``veles_tpu/znicz/samples/kohonen.py`` (the
Znicz DemoKohonen sample): a synthetic dataset of 2-D Gaussian clusters
(numpy ``RandomState(7)``, the JAX sample's bytes) mapped by a
:class:`~veles_tpu_torch.znicz.kohonen.KohonenTrainer`; the quantization
error drops as the codebook unfolds over the data.

    from veles_tpu_torch.znicz.samples import kohonen
    wf = kohonen.create_workflow(decision={"silent": True})
    wf.initialize()              # the card; Device(backend="cpu") = host
    wf.run()
    wf.decision.qerror_history   # one mean quantization error an epoch
"""

import numpy

from ...config import root
from ...loader.base import TEST, VALID, TRAIN
from ...loader.fullbatch import FullBatchLoader
from ...plumbing import Repeater
from ...workflow import Workflow
from ..kohonen import KohonenTrainer, KohonenDecision

__all__ = ["KohonenLoader", "KohonenWorkflow", "create_workflow", "run"]

root.kohonen.update({
    "loader": {"minibatch_size": 50, "normalization_type": "none"},
    "trainer": {"shape": (8, 8), "learning_rate": 0.5,
                "learning_rate_final": 0.05},
    "decision": {"max_epochs": 30},
})


class KohonenLoader(FullBatchLoader):
    """Synthetic 2-D clusters (train only, unlabeled)."""

    MAPPING = "kohonen_demo_loader"

    def __init__(self, workflow, **kwargs):
        self.n_train = kwargs.pop("n_train", 1000)
        self.n_clusters = kwargs.pop("n_clusters", 4)
        super().__init__(workflow, **kwargs)
        self.has_labels = False

    def load_data(self):
        rng = numpy.random.RandomState(7)
        centers = rng.uniform(-2.0, 2.0, (self.n_clusters, 2))
        per = self.n_train // self.n_clusters
        chunks = [centers[i] + 0.25 * rng.randn(per, 2)
                  for i in range(self.n_clusters)]
        data = numpy.concatenate(chunks).astype(numpy.float32)
        rng.shuffle(data)
        self.original_data.mem = data
        self.class_lengths[TEST] = 0
        self.class_lengths[VALID] = 0
        self.class_lengths[TRAIN] = len(data)


class KohonenWorkflow(Workflow):
    """repeater → loader → trainer → decision → loop (no gradients)."""

    def __init__(self, launcher, **kwargs):
        super().__init__(launcher, name=kwargs.pop("name", "DemoKohonen"))
        loader_cfg = dict(root.kohonen.loader.todict())
        loader_cfg.update(kwargs.pop("loader", {}))
        trainer_cfg = dict(root.kohonen.trainer.todict())
        trainer_cfg.update(kwargs.pop("trainer", {}))
        decision_cfg = dict(root.kohonen.decision.todict())
        decision_cfg.update(kwargs.pop("decision", {}))
        trainer_cfg.setdefault("epochs", decision_cfg.get("max_epochs", 30))

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.loader = KohonenLoader(self, **loader_cfg)
        self.loader.link_from(self.repeater)
        self.trainer = KohonenTrainer(self, **trainer_cfg)
        self.trainer.link_from(self.loader)
        self.trainer.link_loader(self.loader)
        self.decision = KohonenDecision(self, **decision_cfg)
        self.decision.link_from(self.trainer)
        self.decision.link_loader(self.loader)
        self.decision.link_trainer(self.trainer)
        self.repeater.link_from(self.decision)
        self.end_point.link_from(self.decision)
        self.repeater.gate_block = self.decision.complete
        self.end_point.gate_block = ~self.decision.complete


def create_workflow(**overrides):
    return KohonenWorkflow(None, **overrides)


def run(load, main):
    load(create_workflow)
    main()
