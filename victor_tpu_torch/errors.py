class InputError(Exception):
    """Error raised when something is wrong with the input data.

    API-compatible with the reference exception (victor/utils.py:5).
    """
