"""Learning-rate adjusters: a schedule over the configured base rates.

The port of ``veles_tpu/znicz/lr_adjust.py`` (the Znicz lr_adjust
family).  A policy maps the epoch to a multiplier of the base rates:

- ``exp``:       scale = gamma ** epoch
- ``step``:      scale = gamma ** (epoch // step)
- ``inv``:       scale = (1 + gamma * epoch) ** -power
- ``arbitrary``: explicit ``[(epoch, scale), ...]`` step points

In fused mode the adjuster sets the step's ``lr_scale``, which the step
multiplies into each rate in f32, as the JAX step does
(:class:`~.fused.FusedTrainStep`; a :class:`~.scan_step.ScanEpochStep`
captures its train graph again for each new scale).  In graph mode it
writes ``base * scale`` into the GD units' ``learning_rate`` and
``learning_rate_bias``.

    adj = LearningRateAdjuster(wf, policy="exp", gamma=0.9)
    adj.link_from(wf.decision)
    adj.link_loader(wf.loader)
    adj.link_fused(wf.fused_step)      # or adj.link_gds(*wf.gds)
"""

from ..units import Unit

__all__ = ["make_policy", "LearningRateAdjuster"]


def make_policy(name, **kwargs):
    """The policy ``name`` as a function of the epoch; an unknown name
    raises ``ValueError``."""
    gamma = float(kwargs.get("gamma", 0.9))
    if name == "exp":
        return lambda epoch: gamma ** epoch
    if name == "step":
        step = int(kwargs.get("step", 10))
        return lambda epoch: gamma ** (epoch // step)
    if name == "inv":
        power = float(kwargs.get("power", 0.75))
        return lambda epoch: (1.0 + gamma * epoch) ** -power
    if name == "arbitrary":
        points = sorted(kwargs["points"])  # [(epoch, scale), ...]

        def arbitrary(epoch):
            scale = 1.0
            for at, value in points:
                if epoch >= at:
                    scale = value
            return scale
        return arbitrary
    raise ValueError("unknown lr policy %r" % name)


class LearningRateAdjuster(Unit):
    """Applies a schedule once per epoch, at its end, for the next one.

    Wire: ``link_from(decision)``, ``link_loader(loader)`` (the gate:
    it runs when an epoch ends), and ``link_fused(fused_step)`` or
    ``link_gds(*gd_units)`` (graph mode).
    """

    MAPPING = "lr_adjuster"

    def __init__(self, workflow, policy="exp", **kwargs):
        super().__init__(workflow, **kwargs)
        self.view_group = "TRAINER"
        self.policy_name = policy
        self.policy_kwargs = dict(kwargs)
        self.policy_kwargs.pop("name", None)
        # built here: a bad name or points fail at construction, not an
        # epoch later
        self._policy_ = make_policy(policy, **self.policy_kwargs)
        self.epoch_ended = None      # linked
        self.epoch_number = None
        self.loader = None
        self.fused_step = None
        self.gds = []
        self._base_rates = None

    def init_unpickled(self):
        super().init_unpickled()
        # also called from Unit.__init__, before the attributes exist:
        # only a real unpickle rebuilds the policy
        name = self.__dict__.get("policy_name")
        if name is not None:
            self._policy_ = make_policy(name, **self.policy_kwargs)

    def link_loader(self, loader):
        self.loader = loader
        self.link_attrs(loader, "epoch_ended", "epoch_number")
        self.gate_skip = ~loader.epoch_ended
        return self

    def initialize(self, **kwargs):
        super().initialize(**kwargs)
        if self.loader is not None:
            # a derived Bool pickles as its value: a restored adjuster
            # rebuilds its epoch gate (the JAX unit's stays constant)
            self.gate_skip = ~self.loader.epoch_ended

    def link_fused(self, fused_step):
        self.fused_step = fused_step
        return self

    def link_gds(self, *gds):
        self.gds = list(gds)
        self._base_rates = [(gd.learning_rate, gd.learning_rate_bias)
                            for gd in gds]
        return self

    def scale_for(self, epoch):
        return self._policy_(epoch)

    def run(self):
        # the schedule of the NEXT epoch (this runs at the end of one)
        scale = self.scale_for(int(self.epoch_number) + 1)
        if self.fused_step is not None:
            # composed with a WeightsRollback's damping: an assignment
            # of the bare scale would undo it
            damping = getattr(self.fused_step, "lr_damping", 1.0)
            self.fused_step.lr_scale = float(scale * damping)
        for gd, (base_w, base_b) in zip(self.gds, self._base_rates or ()):
            gd.learning_rate = base_w * scale
            gd.learning_rate_bias = base_b * scale
