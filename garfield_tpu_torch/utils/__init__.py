"""Helpers of the port: logging and device resolution (``tools``), loss and
optimizer selection (``selectors``)."""
