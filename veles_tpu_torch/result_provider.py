"""Result provider protocol (reference: veles/result_provider.py).

Units that produce final metrics implement ``get_metric_names`` /
``get_metric_values``; Workflow.gather_results collects them into the
``--result-file`` JSON (reference workflow.py:827-849).
"""


class IResultProvider:
    def get_metric_names(self):
        return set()

    def get_metric_values(self):
        return {}
