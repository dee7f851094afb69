"""The port's PDF, DOCX and XLSX loaders against the JAX reference's, on the CPU.

The inputs are the reference's own (``tests/test_pdf.py``, ``test_office.py``,
``test_loader.py``): both packages must extract equal text, equal pages (number,
text, modality, OCR confidence, image bytes) and raise the same error with the same
message where the reference raises. One case is the port's addition: a PDF with no
text layer whose page is an image is OCR'd when an OCR processor is configured
(the reference raises there without PyMuPDF). A PDF and a DOCX ingest through both
facades and answer the same query with equal ids.
"""

import io
import json
import struct
import zlib

import numpy as np
import pytest

from triple_hybrid_rag_tpu.facade import RAG as RefRAG
from triple_hybrid_rag_tpu.loader import DocumentLoader as RefLoader
from triple_hybrid_rag_tpu.loader import UnsupportedFormatError as RefUnsupported
from triple_hybrid_rag_tpu.loader import detect_file_type as ref_detect
from triple_hybrid_rag_tpu.office_text import extract_docx_text as ref_docx
from triple_hybrid_rag_tpu.office_text import extract_xlsx_tables as ref_xlsx
from triple_hybrid_rag_tpu.pdf_text import extract_pdf_text as ref_pdf
from triple_hybrid_rag_tpu.types import OCRResult as RefOCRResult

from test_office import DOCX_XML, make_docx, make_xlsx
from test_pdf import CONTENT_1, CONTENT_2, make_pdf
from test_torch_staged import _compare
from torch_port_helpers import torch_config
from triple_hybrid_rag_tpu_torch.facade import RAG
from triple_hybrid_rag_tpu_torch.loader import DocumentLoader, UnsupportedFormatError, detect_file_type
from triple_hybrid_rag_tpu_torch.office_text import extract_docx_text, extract_xlsx_tables
from triple_hybrid_rag_tpu_torch.pdf_text import extract_pdf_images, extract_pdf_text
from triple_hybrid_rag_tpu_torch.types import OCRResult

_HEX = b"BT <5061796d656e74> Tj ET"
_ESCAPED = rb"BT (paren \( close \) and \164ab) Tj ET"
_MARKET = b"BT (MARKET report) Tj T* (second ' line) ' (third) \" ET"
_UTF16 = b"BT (\xfe\xff\x00P\x00a\x00y) Tj <FEFF00410042> Tj ET"
_ENCRYPTED = make_pdf([CONTENT_1]).replace(b"trailer\n<<", b"trailer\n<< /Encrypt 9 0 R")

PDFS = {
    "flate-literal": make_pdf([CONTENT_1]),
    "tj-kerning": make_pdf([CONTENT_2]),
    "uncompressed-multipage": make_pdf([CONTENT_1, CONTENT_2], compress=False),
    "hex": make_pdf([_HEX]),
    "escapes-octal": make_pdf([_ESCAPED]),
    "quote-operators": make_pdf([_MARKET]),
    "utf16": make_pdf([_UTF16]),
    "encrypted": _ENCRYPTED,
    "garbage": b"%PDF-1.4 not really",
    "no-text": b"%PDF-1.4\n1 0 obj\n<<>>\nendobj\ntrailer\n%%EOF",
}

_DOCX_ENTITIES = """<?xml version="1.0"?>
<w:document xmlns:w="x"><w:body>
<w:p><w:pPr><w:pStyle w:val="Heading2"/></w:pPr><w:r><w:t>Terms &amp;lt;draft&amp;gt;</w:t></w:r></w:p>
<w:p><w:r><w:t xml:space="preserve">Split </w:t></w:r><w:r><w:t>wo</w:t></w:r><w:r><w:t>rd &quot;q&quot;</w:t></w:r></w:p>
</w:body></w:document>"""
DOCXS = {"policy": DOCX_XML, "entities-runs": _DOCX_ENTITIES}

XLSXS = {
    "prices": (["item", "price", "setup", "monthly"],
               [[("s", 0), ("s", 1)], [("s", 2), ("n", 100)], [("s", 3), ("n", 40)]]),
    "numbers": (["a", "b"], [[("s", 0), ("s", 1)], [("n", 1), ("n", 2.5)]]),
}


def _sparse_xlsx() -> bytes:
    """Two sheets (sheet10 before sheet2 lexicographically), an omitted blank cell
    and an inline string."""
    buf = io.BytesIO()
    import zipfile

    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("xl/sharedStrings.xml", "<sst><si><t>name</t></si><si><t>qty</t></si></sst>")
        zf.writestr("xl/worksheets/sheet2.xml",
                    '<worksheet><sheetData><row r="1"><c r="A1" t="s"><v>0</v></c>'
                    '<c r="C1" t="s"><v>1</v></c></row><row r="2"><c r="A2" t="inlineStr">'
                    '<is><t>bolt</t></is></c><c r="C2"><v>7</v></c></row></sheetData></worksheet>')
        zf.writestr("xl/worksheets/sheet10.xml",
                    '<worksheet><sheetData><row r="1"><c r="B1"><v>3</v></c></row></sheetData></worksheet>')
    return buf.getvalue()


def _png(w: int, h: int) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + b"\x00\x00\x00\rIHDR" + struct.pack(">II", w, h) + b"\x00" * 16


class _StubOCR:
    """An OCR processor answering a fixed text (``test_loader.py``'s stub)."""

    def __init__(self, result_type):
        self.result_type = result_type

    def process_image(self, data, mode=None):
        return self.result_type(text="extracted text", confidence=0.9, mode="base")


# (file name, bytes, with the stub OCR processor)
FILES = {
    "doc.pdf": (make_pdf([CONTENT_1, CONTENT_2]), False),
    "scan.pdf": (PDFS["no-text"], False),
    "fake.pdf": (b"%PDF-1.4 fake", False),
    "policy.docx": (make_docx(DOCX_XML), False),
    "prices.xlsx": (make_xlsx(["a", "b"], [[("s", 0), ("s", 1)], [("n", 1), ("n", 2)]]), False),
    "sparse.xlsx": (_sparse_xlsx(), False),
    "bad.docx": (b"PK\x03\x04 not a zip", False),
    "empty.docx": (make_docx("<w:document><w:body></w:body></w:document>"), False),
    "img.png": (b"\x89PNG\r\n\x1a\n" + b"\x00" * 32, False),
    "ocr.png": (_png(10, 10), True),
    "noext": (b"%PDF-1.7 rest", False),
    "doc.md": (b"# Title\n\nSome content here.", False),
    "big.txt": ("\n\n".join(f"Paragraph {i} " + "word " * 100 for i in range(30)).encode(), False),
    "data.csv": (b"name,price\nwidget,10\ngadget,20\n", False),
    "cfg.json": (json.dumps({"a": {"b": 1}, "items": ["x", "y"]}).encode(), False),
    "page.html": (b"<html><body><h2>Prices</h2><table><tr><th>item</th><th>price</th></tr>"
                  b"<tr><td>setup</td><td><b>100</b></td></tr></table><p>After.</p>"
                  b"<script>alert(1)</script></body></html>", False),
}


def _pages(doc):
    return [(p.page_number, p.text, getattr(p.modality, "value", p.modality), p.ocr_confidence,
             p.image_bytes) for p in doc.pages]


@pytest.mark.parametrize("name", list(PDFS))
def test_pdf_text_matches_reference(name):
    assert extract_pdf_text(PDFS[name]) == ref_pdf(PDFS[name])


@pytest.mark.parametrize("name", list(DOCXS))
def test_docx_text_matches_reference(name):
    data = make_docx(DOCXS[name])
    assert extract_docx_text(data) == ref_docx(data)


@pytest.mark.parametrize("name", list(XLSXS) + ["sparse"])
def test_xlsx_tables_match_reference(name):
    data = _sparse_xlsx() if name == "sparse" else make_xlsx(*XLSXS[name])
    assert extract_xlsx_tables(data) == ref_xlsx(data)


@pytest.mark.parametrize("path,data", [
    ("a.pdf", None), ("a.PNG", None), ("a.xyz", None), ("noext", b"%PDF-1.7 rest"),
    ("noext", b"\x89PNG\r\n\x1a\nxxxx"), ("a.xlsx", b"PK\x03\x04zip"), ("a.docx", b"PK\x03\x04"),
    ("noext", b"PK\x03\x04"), ("a.bin", b"RIFF\x00\x00\x00\x00WEBPVP8 "), ("a.txt", b"RIFFxxxxWEBP"),
], ids=range(10))
def test_detect_file_type_matches_reference(path, data):
    assert detect_file_type(path, data).value == ref_detect(path, data).value


@pytest.mark.parametrize("name", list(FILES))
def test_loader_matches_reference(tmp_path, name):
    data, with_ocr = FILES[name]
    path = tmp_path / name
    path.write_bytes(data)
    ref = RefLoader(ocr_processor=_StubOCR(RefOCRResult) if with_ocr else None)
    port = DocumentLoader(ocr_processor=_StubOCR(OCRResult) if with_ocr else None)
    try:
        want = ref.load(path)
    except RefUnsupported as e:
        with pytest.raises(UnsupportedFormatError) as got:
            port.load(path)
        assert str(got.value) == str(e)
        return
    got = port.load(path)
    assert (got.filename, got.file_type.value) == (want.filename, want.file_type.value)
    assert _pages(got) == _pages(want)


def _image_pdf(pixels: np.ndarray, predictor: bool) -> bytes:
    """A one-page PDF whose page is a grayscale image XObject and no text: FlateDecode
    rows with PNG filter bytes (``/Predictor 15``, how a PNG embeds) or plain
    FlateDecode pixels."""
    h, w = pixels.shape
    if predictor:
        raw = zlib.compress(b"".join(b"\x00" + pixels[y].tobytes() for y in range(h)))
        parms = b" /DecodeParms << /Predictor 15 /Colors 1 /BitsPerComponent 8 /Columns %d >>" % w
    else:
        raw, parms = zlib.compress(pixels.tobytes()), b""
    content = b"q %d 0 0 %d 0 0 cm /Im0 Do Q" % (w, h)
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %d %d] /Contents 4 0 R "
        b"/Resources << /XObject << /Im0 5 0 R >> >> >>" % (w, h),
        b"<< /Length %d >>\nstream\n%s\nendstream" % (len(content), content),
        b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace /DeviceGray "
        b"/BitsPerComponent 8 /Filter /FlateDecode%s /Length %d >>\nstream\n%s\nendstream"
        % (w, h, parms, len(raw), raw),
    ]
    body = b"%PDF-1.4\n" + b"".join(b"%d 0 obj\n%s\nendobj\n" % (i + 1, o) for i, o in enumerate(objs))
    return body + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n"


@pytest.mark.parametrize("predictor", [True, False], ids=["png-predictor", "raw-flate"])
def test_image_only_pdf_is_ocrd(tmp_path, predictor):
    """The port's addition: with an OCR processor, a PDF without a text layer has
    its page image OCR'd (the pixels come back as a PNG); the reference raises."""
    from PIL import Image

    pixels = (np.arange(12 * 20, dtype=np.uint8).reshape(12, 20) * 3) % 251
    data = _image_pdf(pixels, predictor)
    (png,) = extract_pdf_images(data)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), pixels)
    path = tmp_path / "scan.pdf"
    path.write_bytes(data)
    doc = DocumentLoader(ocr_processor=_StubOCR(OCRResult)).load(path)
    assert _pages(doc) == [(1, "extracted text", "text", 0.9, None)]
    with pytest.raises(RefUnsupported, match="no text extractable"):
        RefLoader(ocr_processor=_StubOCR(RefOCRResult)).load(path)
    with pytest.raises(UnsupportedFormatError, match="no text extractable"):
        DocumentLoader().load(path)


@pytest.mark.parametrize("name,data,query", [
    ("policy.pdf", make_pdf([CONTENT_1]), "invoice settlement days"),
    ("policy.docx", make_docx(DOCX_XML), "invoice settlement thirty days"),
    ("prices.xlsx", make_xlsx(*XLSXS["prices"]), "setup price"),
], ids=["pdf", "docx", "xlsx"])
def test_format_ingest_to_query_matches_reference(tmp_path, small_config, name, data, query):
    """``test_pdf.py`` / ``test_office.py``'s ingest-to-query through both facades:
    the same chunk ids and scores, through the default OCR-capable loader."""
    cfg = small_config.replace(graph_enabled=False, embedding_dtype="float32", safety_threshold=0.2)
    path = tmp_path / name
    path.write_bytes(data)
    ref, port = RefRAG(config=cfg), RAG(torch_config(cfg), device="cpu")
    assert port.ingestor.loader.ocr is not None
    results = [r.ingest(path) for r in (ref, port)]
    assert [(x.status.value, x.n_children, x.doc_id) for x in results[1:]] == [
        (results[0].status.value, results[0].n_children, results[0].doc_id)]
    _compare(ref.query(query), port.query(query))
