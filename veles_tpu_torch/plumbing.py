"""Control-flow plumbing units.

Reference: veles/plumbing.py:36-112.
"""

from .units import Unit, TrivialUnit


class StartPoint(TrivialUnit):
    """Workflow entry point; fired by Workflow.run."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Start")
        super().__init__(workflow, **kwargs)


class EndPoint(TrivialUnit):
    """Workflow exit: running it finishes the workflow (plumbing.py:80)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "End")
        super().__init__(workflow, **kwargs)

    def run(self):
        self.workflow.on_workflow_finished()


class Repeater(TrivialUnit):
    """Loop head: opens on any input link (ignores the AND-gate)."""

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Repeater")
        super().__init__(workflow, **kwargs)
        self.ignores_gate = True


class FireStarter(Unit):
    """Resets the ``stopped`` flag of chosen units so loops may restart
    (plumbing.py:91)."""

    def __init__(self, workflow, **kwargs):
        super().__init__(workflow, **kwargs)
        self.units_to_fire = list(kwargs.get("units", ()))

    def run(self):
        for unit in self.units_to_fire:
            unit.stopped = False
